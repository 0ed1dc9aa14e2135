"""Keras ResNet-50 ImageNet training on horovod_tpu_torch: the full
distributed-training recipe.

Counterpart of examples/keras_imagenet_resnet50.py: ResNet-50 on the
Keras surface with the learning rate linearly scaled by the world size
and warmed up (Goyal et al.; ``LearningRateWarmupCallback``), the
30/60/80-epoch staircase decay (``LearningRateScheduleCallback``),
metric averaging across ranks, the initial broadcast, the fp16-allreduce
option, and rank-0-only checkpointing and verbosity, over
``horovod_tpu_torch.keras``. Synthetic ImageNet-shaped data keeps it
hermetic; the default checkpoint format lies under the temporary
directory. The engine runs on the card by default, on the CPU with
``--device cpu``. Prints a JSON summary as its last line.
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
    description="Keras ImageNet ResNet-50 Example",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--checkpoint-format",
                    default=os.path.join(tempfile.gettempdir(),
                                         "checkpoint-{epoch}.keras"),
                    help="checkpoint file format")
parser.add_argument("--fp16-allreduce", action="store_true", default=False,
                    help="use fp16 compression during allreduce")
# Defaults from the Goyal et al. recipe (https://arxiv.org/abs/1706.02677),
# like the reference.
parser.add_argument("--batch-size", type=int, default=32,
                    help="input batch size for training")
parser.add_argument("--epochs", type=int, default=90,
                    help="number of epochs to train")
parser.add_argument("--base-lr", type=float, default=0.0125,
                    help="learning rate for a single rank")
parser.add_argument("--warmup-epochs", type=float, default=5,
                    help="number of warmup epochs")
parser.add_argument("--momentum", type=float, default=0.9,
                    help="SGD momentum")
parser.add_argument("--samples", type=int, default=256,
                    help="synthetic samples per epoch")
parser.add_argument("--num-classes", type=int, default=1000)
parser.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (default) or cpu")
args = parser.parse_args()


def main():
    hvd.init(device=args.device)

    model = tf.keras.applications.ResNet50(weights=None,
                                           classes=args.num_classes)

    # Reference recipe: scale LR by the number of ranks; warmup ramps to
    # it over the first epochs, then the 30/60/80 staircase decays it.
    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=args.base_lr * hvd.size(),
                                momentum=args.momentum),
        compression=(hvd.Compression.fp16 if args.fp16_allreduce
                     else hvd.Compression.none))
    model.compile(optimizer=opt,
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])

    callbacks = [
        # broadcast initial variables so a rank-0 restore reaches everyone
        hvd.BroadcastGlobalVariablesCallback(0),
        hvd.MetricAverageCallback(),
        hvd.LearningRateWarmupCallback(warmup_epochs=args.warmup_epochs,
                                       verbose=1),
        hvd.LearningRateScheduleCallback(start_epoch=args.warmup_epochs,
                                         end_epoch=30, multiplier=1.0),
        hvd.LearningRateScheduleCallback(start_epoch=30, end_epoch=60,
                                         multiplier=1e-1),
        hvd.LearningRateScheduleCallback(start_epoch=60, end_epoch=80,
                                         multiplier=1e-2),
        hvd.LearningRateScheduleCallback(start_epoch=80, multiplier=1e-3),
    ]
    # rank-0-only checkpointing, like the reference
    if hvd.rank() == 0:
        callbacks.append(
            tf.keras.callbacks.ModelCheckpoint(args.checkpoint_format))

    x = np.random.randn(args.samples, 224, 224, 3).astype("float32")
    y = np.random.randint(0, args.num_classes, args.samples)
    history = model.fit(x, y, batch_size=args.batch_size,
                        epochs=args.epochs, callbacks=callbacks,
                        verbose=2 if hvd.rank() == 0 else 0)

    score = model.evaluate(x[: args.batch_size], y[: args.batch_size],
                           verbose=0)
    if hvd.rank() == 0:
        print(f"Final loss: {score[0]:.4f}  accuracy: {score[1]:.4f}")
    summary = {"example": "keras_imagenet_resnet50", "rank": hvd.rank(),
               "losses": [float(v) for v in history.history["loss"]],
               "final_loss": float(score[0])}
    hvd.shutdown()
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
