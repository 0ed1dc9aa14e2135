"""TF2 eager MNIST with DistributedGradientTape on horovod_tpu_torch.

Counterpart of examples/tensorflow_mnist_eager.py: an eager training
loop, ``hvd.DistributedGradientTape`` around the tape, one broadcast of
the model's and the optimizer's variables after the first step
(variables must exist before they can be broadcast), rank-0-only
checkpointing (``CHECKPOINT_DIR``, default under the temporary
directory), over ``horovod_tpu_torch.tensorflow``. The engine runs on
the card by default, on the CPU with ``--device cpu``. Prints a JSON
summary (the step losses) as its last line.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd

parser = argparse.ArgumentParser(
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (default) or cpu")
args = parser.parse_args()


def main():
    hvd.init(device=args.device)

    model = tf.keras.Sequential([
        tf.keras.layers.Input((784,)),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10),
    ])
    loss_obj = tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True)
    opt = tf.keras.optimizers.SGD(0.01 * hvd.size())

    x = np.random.randn(512, 784).astype("float32")
    y = np.random.randint(0, 10, 512).astype("int64")
    dataset = (tf.data.Dataset.from_tensor_slices((x, y))
               .shard(hvd.size(), hvd.rank()).batch(32))

    losses = []
    for step, (images, labels) in enumerate(dataset.take(8)):
        with tf.GradientTape() as tape:
            logits = model(images, training=True)
            loss = loss_obj(labels, logits)

        # Wrap the tape: gradients come back allreduce-averaged.
        tape = hvd.DistributedGradientTape(tape)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))

        if step == 0:
            # Broadcast AFTER the first apply (reference: variables are
            # created lazily; broadcasting before they exist is a no-op).
            hvd.broadcast_variables(model.variables, root_rank=0)
            hvd.broadcast_variables(opt.variables, root_rank=0)

        if step % 2 == 0 and hvd.rank() == 0:
            print(f"Step {step}  loss {float(loss):.4f}")
        losses.append(float(loss))

    if hvd.rank() == 0:
        ckpt_dir = os.environ.get(
            "CHECKPOINT_DIR",
            os.path.join(tempfile.gettempdir(), "tf_mnist_eager"))
        tf.train.Checkpoint(model=model).save(
            os.path.join(ckpt_dir, "ckpt"))
    summary = {"example": "tensorflow_mnist_eager", "rank": hvd.rank(),
               "losses": losses}
    hvd.shutdown()
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
