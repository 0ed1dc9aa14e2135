"""MNIST on horovod_tpu_torch's Keras binding with the Horovod callback
set.

Counterpart of examples/keras_mnist.py: ``DistributedOptimizer`` around
the Keras optimizer, ``BroadcastGlobalVariablesCallback``,
``MetricAverageCallback``, ``LearningRateWarmupCallback``, over
``horovod_tpu_torch.keras``. Synthetic data keeps it hermetic: seeded
MNIST-shaped images labelled by a fixed linear map of the pixels (the
JAX example draws its labels at random), so the loss falls epoch over
epoch. The engine runs on the card by default, on the CPU with
``--device cpu``. Prints a JSON summary (the epoch losses) as its last
line.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.keras as hvd

parser = argparse.ArgumentParser(
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (default) or cpu")
args = parser.parse_args()


def main():
    hvd.init(device=args.device)
    tf.keras.utils.set_random_seed(1234)
    model = tf.keras.Sequential([
        tf.keras.layers.Input((784,)),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10, activation="softmax"),
    ])
    # Scale LR by world size; warmup eases it in
    # (reference: keras_mnist_advanced.py).
    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.01 * hvd.size(), momentum=0.9))
    model.compile(optimizer=opt,
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])

    callbacks = [
        hvd.BroadcastGlobalVariablesCallback(0),
        hvd.MetricAverageCallback(),
        hvd.LearningRateWarmupCallback(warmup_epochs=2, verbose=0),
    ]
    rng = np.random.default_rng(1234 + hvd.rank())
    x = rng.standard_normal((640, 784), np.float32)
    w_true = np.random.default_rng(7).standard_normal((784, 10), np.float32)
    y = (x @ w_true).argmax(1)
    history = model.fit(x, y, batch_size=32, epochs=3, callbacks=callbacks,
                        verbose=2 if hvd.rank() == 0 else 0)
    summary = {"example": "keras_mnist", "rank": hvd.rank(),
               "losses": [float(v) for v in history.history["loss"]]}
    hvd.shutdown()
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
