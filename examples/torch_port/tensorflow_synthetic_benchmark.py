"""TensorFlow synthetic benchmark on horovod_tpu_torch's TensorFlow
binding.

Counterpart of examples/tensorflow_synthetic_benchmark.py (the
reference's named parity vehicle): a Keras applications model on
synthetic data, ``hvd.allreduce`` of the gradients each batch,
``--num-warmup-batches`` untimed, then ``--num-iters`` iterations of
``--num-batches-per-iter`` batches, printing ``Img/sec per <device>:
mean +- 1.96 sigma``. The wire is the port's eager engine, reached
through ``horovod_tpu_torch.tensorflow`` (TensorFlow's values cross on
the host); the engine runs on the card by default, on the CPU with
``--device cpu``. The port's own protocol on torch is
examples/torch_port/pytorch_synthetic_benchmark.py. Prints a JSON
summary as its last line.
"""

import argparse
import json
import os
import sys
import timeit

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd

parser = argparse.ArgumentParser(
    description="TensorFlow Synthetic Benchmark",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--fp16-allreduce", action="store_true", default=False,
                    help="use fp16 compression during allreduce")
parser.add_argument("--model", type=str, default="ResNet50",
                    help="keras.applications model to benchmark")
parser.add_argument("--batch-size", type=int, default=32,
                    help="input batch size")
parser.add_argument("--num-warmup-batches", type=int, default=10,
                    help="number of warm-up batches that don't count "
                         "towards benchmark")
parser.add_argument("--num-batches-per-iter", type=int, default=10,
                    help="number of batches per benchmark iteration")
parser.add_argument("--num-iters", type=int, default=10,
                    help="number of benchmark iterations")
parser.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (default) or cpu")
args = parser.parse_args()


def main():
    hvd.init(device=args.device)

    model_cls = getattr(tf.keras.applications, args.model)
    model = model_cls(weights=None)
    opt = tf.keras.optimizers.SGD(0.01)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)

    data = tf.random.uniform([args.batch_size, 224, 224, 3])
    target = tf.random.uniform([args.batch_size, 1], minval=0, maxval=999,
                               dtype=tf.int64)
    loss_fn = tf.losses.SparseCategoricalCrossentropy()

    def benchmark_step():
        with tf.GradientTape() as tape:
            probs = model(data, training=True)
            loss = loss_fn(target, probs)
        grads = tape.gradient(loss, model.trainable_variables)
        grads = [hvd.allreduce(g, average=True, compression=compression,
                               name=f"syn.{i}")
                 for i, g in enumerate(grads)]
        opt.apply_gradients(zip(grads, model.trainable_variables))

    device = "GPU" if args.device.startswith("cuda") else "CPU"
    print(f"Model: {args.model}")
    print(f"Batch size: {args.batch_size}")
    print(f"Number of {device}s: {hvd.size()}")

    print("Running warmup...")
    timeit.timeit(benchmark_step, number=args.num_warmup_batches)

    print("Running benchmark...")
    img_secs = []
    for _ in range(args.num_iters):
        t = timeit.timeit(benchmark_step, number=args.num_batches_per_iter)
        img_sec = args.batch_size * args.num_batches_per_iter / t
        print(f"Iter #{_}: {img_sec:.1f} img/sec per {device}")
        img_secs.append(img_sec)

    img_sec_mean = np.mean(img_secs)
    img_sec_conf = 1.96 * np.std(img_secs)
    print(f"Img/sec per {device}: {img_sec_mean:.1f} +-{img_sec_conf:.1f}")
    print(f"Total img/sec on {hvd.size()} {device}(s): "
          f"{img_sec_mean * hvd.size():.1f} "
          f"+-{img_sec_conf * hvd.size():.1f}")
    summary = {"example": "tensorflow_synthetic_benchmark",
               "rank": hvd.rank(), "model": args.model,
               "img_sec_per_rank": float(img_sec_mean)}
    hvd.shutdown()
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
