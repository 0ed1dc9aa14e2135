"""Synthetic ResNet-50 benchmark on horovod_tpu_torch.

Counterpart of examples/pytorch_synthetic_benchmark.py and
examples/jax_synthetic_benchmark.py: the same protocol and flags (a
warm-up, then --num-iters timed iterations of --num-batches-per-iter
steps of SGD 0.01 on one synthetic batch, img/s a rank with its 95%
interval), over the port's ResNet-50 (horovod_tpu_torch/models/
resnet.py) at its published width, bf16 compute, channels_last on a
card, through ``DistributedOptimizer`` and ``broadcast_parameters``
(--fp16-allreduce compresses the exchange). ``python -m
horovod_tpu_torch.bench.resnet`` is the port's full bench protocol;
this script is the user-facing recipe. Runs on the card by default, on
the CPU with ``--device cpu`` (a small --image-size keeps that quick).

Run: python examples/torch_port/pytorch_synthetic_benchmark.py
     python -m horovod_tpu_torch.run -np 2 python
         examples/torch_port/pytorch_synthetic_benchmark.py
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch
import torch.nn as nn

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import ResNet50

parser = argparse.ArgumentParser(
    description="PyTorch Synthetic Benchmark",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--fp16-allreduce", action="store_true", default=False,
                    help="use fp16 compression during allreduce")
parser.add_argument("--model", type=str, default="ResNet50",
                    choices=["ResNet50"], help="model to benchmark")
parser.add_argument("--batch-size", type=int, default=32,
                    help="input batch size")
parser.add_argument("--num-warmup-batches", type=int, default=10,
                    help="number of warm-up batches that don't count "
                         "towards benchmark")
parser.add_argument("--num-batches-per-iter", type=int, default=10,
                    help="number of batches per benchmark iteration")
parser.add_argument("--num-iters", type=int, default=10,
                    help="number of benchmark iterations")
parser.add_argument("--image-size", type=int, default=224)
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = parser.parse_args()


def main():
    hvd.init(device=args.device)
    device = hvd.runtime.device()
    fmt = (torch.channels_last if device.type == "cuda"
           else torch.contiguous_format)
    model = ResNet50(generator=torch.Generator().manual_seed(0),
                     device=device).to(memory_format=fmt)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    rng = np.random.default_rng(hvd.rank())
    s = args.image_size
    data = torch.from_numpy(rng.standard_normal(
        (args.batch_size, 3, s, s), np.float32)).to(device).contiguous(
        memory_format=fmt)
    target = torch.from_numpy(rng.integers(0, 1000, args.batch_size)).to(
        device)
    loss_fn = nn.CrossEntropyLoss()
    rank = hvd.rank()

    def benchmark_step():
        optimizer.zero_grad()
        loss = loss_fn(model(data), target)
        loss.backward()
        optimizer.step()

    def timed(n):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            benchmark_step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    def log(s):
        if rank == 0:
            print(s, flush=True)

    log(f"Model: {args.model} (horovod_tpu_torch.models)")
    log(f"Batch size: {args.batch_size}")
    log(f"Number of ranks: {hvd.size()}")
    log("Running warmup...")
    timed(args.num_warmup_batches)
    log("Running benchmark...")
    img_secs = []
    for x in range(args.num_iters):
        img_sec = args.batch_size * args.num_batches_per_iter / timed(
            args.num_batches_per_iter)
        log(f"Iter #{x}: {img_sec:.1f} img/sec per rank")
        img_secs.append(img_sec)
    mean, conf = np.mean(img_secs), 1.96 * np.std(img_secs)
    log(f"Img/sec per rank: {mean:.1f} +-{conf:.1f}")
    log(f"Total img/sec on {hvd.size()} rank(s): {mean * hvd.size():.1f}")
    summary = {"example": "pytorch_synthetic_benchmark", "rank": rank,
               "img_sec_per_rank": float(mean), "img_secs": img_secs}
    hvd.shutdown()
    log(json.dumps(summary))


if __name__ == "__main__":
    main()
