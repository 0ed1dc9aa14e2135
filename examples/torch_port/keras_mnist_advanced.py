"""Advanced Keras MNIST on horovod_tpu_torch: the full callback recipe.

Counterpart of examples/keras_mnist_advanced.py: a conv net, the
learning rate scaled by the world size, warmed up over the first epochs
and then decayed in a staircase (``LearningRateWarmupCallback`` and
``LearningRateScheduleCallback``), metrics averaged across ranks,
rank-0-only verbosity and checkpointing (``CHECKPOINT_PATH``, default
under the temporary directory), over ``horovod_tpu_torch.keras``.
Synthetic data keeps it hermetic. The engine runs on the card by
default, on the CPU with ``--device cpu``. Prints a JSON summary as its
last line.
"""

import argparse
import json
import os
import sys
import tempfile

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

    model = tf.keras.Sequential([
        tf.keras.layers.Input((28, 28, 1)),
        tf.keras.layers.Conv2D(32, 3, activation="relu"),
        tf.keras.layers.Conv2D(64, 3, activation="relu"),
        tf.keras.layers.MaxPooling2D(2),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dropout(0.25),
        tf.keras.layers.Dense(10, activation="softmax"),
    ])

    # Goyal et al. recipe: linear-scale the LR by size(), warm it up over
    # the first epochs, then staircase-decay (reference:
    # keras_mnist_advanced.py + _keras/callbacks.py:149-168).
    base_lr = 0.01
    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(base_lr * hvd.size(), momentum=0.9))
    model.compile(optimizer=opt,
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])

    callbacks = [
        hvd.BroadcastGlobalVariablesCallback(0),
        hvd.MetricAverageCallback(),
        hvd.LearningRateWarmupCallback(warmup_epochs=2, verbose=0),
        hvd.LearningRateScheduleCallback(start_epoch=2, end_epoch=4,
                                         multiplier=1.0),
        hvd.LearningRateScheduleCallback(start_epoch=4, multiplier=1e-1),
    ]
    if hvd.rank() == 0:
        ckpt = os.environ.get(
            "CHECKPOINT_PATH",
            os.path.join(tempfile.gettempdir(), "keras_mnist_adv.keras"))
        callbacks.append(tf.keras.callbacks.ModelCheckpoint(ckpt))

    x = np.random.randn(512, 28, 28, 1).astype("float32")
    y = np.random.randint(0, 10, 512)
    history = model.fit(x, y, batch_size=32, epochs=5, callbacks=callbacks,
                        validation_split=0.1,
                        verbose=2 if hvd.rank() == 0 else 0)

    score = model.evaluate(x[:64], y[:64], verbose=0)
    if hvd.rank() == 0:
        print(f"Test loss: {score[0]:.4f}  accuracy: {score[1]:.4f}")
    summary = {"example": "keras_mnist_advanced", "rank": hvd.rank(),
               "losses": [float(v) for v in history.history["loss"]],
               "test_loss": float(score[0])}
    hvd.shutdown()
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
