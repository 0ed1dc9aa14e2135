"""MNIST on horovod_tpu_torch's TensorFlow binding (eager,
DistributedGradientTape).

Counterpart of examples/tensorflow_mnist.py: the same structure —
``hvd.init``, ``DistributedGradientTape``, a broadcast of the variables
from rank 0 after the first step — over ``horovod_tpu_torch.tensorflow``,
whose values cross to the port's eager engine on the host. Synthetic data
keeps it hermetic: four seeded batches of images, labelled by a fixed
linear map of the pixels and seen in turn (the JAX example draws fresh
images and random labels every step, on which no loss can fall), so the
loss falls step over step. The engine runs on the card by
default, on the CPU with ``--device cpu``; the machine with the card has
no TensorFlow, so this example runs on the CPU there is. Prints a JSON
summary (the step losses) as its last line.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd

parser = argparse.ArgumentParser(
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (default) or cpu")
args = parser.parse_args()


def main():
    hvd.init(device=args.device)
    tf.keras.utils.set_random_seed(1234 + hvd.rank())
    model = tf.keras.Sequential([
        tf.keras.layers.Input((28, 28, 1)),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10),
    ])
    opt = tf.keras.optimizers.SGD(0.01)
    w_true = tf.random.stateless_normal([784, 10], seed=[7, 0])
    batches = [tf.random.normal([32, 28, 28, 1]) for _ in range(4)]

    losses = []
    for step in range(20):
        x = batches[step % len(batches)]
        y = tf.argmax(tf.reshape(x, [32, 784]) @ w_true, axis=1)
        with hvd.DistributedGradientTape() as tape:
            logits = model(x, training=True)
            loss = tf.reduce_mean(
                tf.keras.losses.sparse_categorical_crossentropy(
                    y, logits, from_logits=True))
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        if step == 0:
            # Broadcast after the first step so optimizer slots exist
            # (reference: tensorflow_mnist_eager.py:63-67).
            hvd.broadcast_variables(model.variables, root_rank=0)
        losses.append(float(loss))
    print(f"[rank {hvd.rank()}] final loss={float(loss):.4f}")
    summary = {"example": "tensorflow_mnist", "rank": hvd.rank(),
               "losses": losses}
    hvd.shutdown()
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
