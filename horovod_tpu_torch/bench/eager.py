"""Eager (op-at-a-time) data-plane throughput of the engine.

Counterpart of bench_eager.py: the reference's motivating workload —
many small gradient tensors submitted op-at-a-time, the reason its
fusion buffer exists (fusion_buffer_manager.{h,cc}) — through
``hvd.allreduce_async`` / ``hvd.synchronize`` (ops/engine.py), with
fusion and the response cache toggled, plus a broadcast of a model's
tensors. Reports wire MB/s: payload bytes x ranks / wall time (on a card,
after the card has finished the round).

    python -m horovod_tpu_torch.bench.eager [--device cpu]

Emits one JSON line (the last of its output), under bench_eager.py's
metric name:

    {"metric": "eager_allreduce_mbytes_sec", "value": N, "unit": "MB/s",
     "vs_baseline": fused_over_unfused_speedup, "configs": {...},
     "device": ..., "card": "<name>, <power limit>"}

bench_eager.py's ``--multihost`` control-plane run has no counterpart
here yet; the engine's negotiation across ranks is checked by
chip_smoke.py's two-rank eager phase and the CPU tests.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import hardware, runtime

CONFIGS = {
    "fused_cached": dict(fusion_threshold=64 * 1024 * 1024,
                         cache_capacity=1024),
    "fused_nocache": dict(fusion_threshold=64 * 1024 * 1024,
                          cache_capacity=0),
    "unfused_cached": dict(fusion_threshold=1, cache_capacity=1024),
    "unfused_nocache": dict(fusion_threshold=1, cache_capacity=0),
}


def _session(device, fusion_threshold=None, cache_capacity=None):
    """A fresh runtime session with the engine knobs set."""
    for knob, value in (("HOROVOD_FUSION_THRESHOLD", fusion_threshold),
                        ("HOROVOD_CACHE_CAPACITY", cache_capacity)):
        if value is None:
            os.environ.pop(knob, None)
        else:
            os.environ[knob] = str(value)
    runtime.shutdown()
    runtime.init(device=device)


def _finish(device):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def run_eager_bench(device, num_tensors=128, elems=1024, repeats=5,
                    fusion_threshold=None, cache_capacity=None):
    """Submit ``num_tensors`` float32 tensors of ``elems`` elements,
    synchronize all, ``repeats`` times after one warm-up round. Returns
    aggregate wire MB/s (payload bytes x ranks / wall time)."""
    import horovod_tpu_torch as hvd
    _session(device, fusion_threshold, cache_capacity)
    dev = runtime.device()
    n = hvd.size()
    data = [torch.from_numpy(np.random.RandomState(i).randn(elems)
                             .astype(np.float32)).to(dev)
            for i in range(num_tensors)]
    nbytes_round = num_tensors * elems * 4 * n

    def one_round(tag):
        handles = [hvd.allreduce_async(t, average=False, name=f"eb.{tag}.{i}")
                   for i, t in enumerate(data)]
        for h in handles:
            hvd.synchronize(h)

    one_round("warm")
    _finish(device)
    t0 = time.perf_counter()
    for r in range(repeats):
        one_round(f"r{r}")
    _finish(device)
    dt = time.perf_counter() - t0
    runtime.shutdown()
    return nbytes_round * repeats / dt / 1e6


def run_broadcast_bench(device, num_tensors=16, elems=262144, repeats=5):
    """broadcast_parameters-style workload: root fans a model's tensors
    out to every rank. Reports payload MB/s (one tensor copy a round)."""
    import horovod_tpu_torch as hvd
    _session(device)
    dev = runtime.device()
    data = [torch.from_numpy(np.random.RandomState(i).randn(elems)
                             .astype(np.float32)).to(dev)
            for i in range(num_tensors)]
    nbytes_round = num_tensors * elems * 4

    def one_round(tag):
        handles = [hvd.broadcast_async(t, 0, name=f"bb.{tag}.{i}")
                   for i, t in enumerate(data)]
        for h in handles:
            hvd.synchronize(h)

    one_round("warm")
    _finish(device)
    t0 = time.perf_counter()
    for r in range(repeats):
        one_round(f"r{r}")
    _finish(device)
    dt = time.perf_counter() - t0
    runtime.shutdown()
    return nbytes_round * repeats / dt / 1e6


def run(device, num_tensors=128, elems=1024, repeats=5):
    """The bench's result dict (its JSON line)."""
    results = {}
    for name, cfg in CONFIGS.items():
        results[name] = run_eager_bench(device, num_tensors, elems, repeats,
                                        **cfg)
        print(f"# {name}: {results[name]:.2f} MB/s", file=sys.stderr)
    results["broadcast"] = run_broadcast_bench(device, repeats=repeats)
    print(f"# broadcast: {results['broadcast']:.2f} MB/s payload",
          file=sys.stderr)
    speedup = (results["fused_cached"] / results["unfused_nocache"]
               if results["unfused_nocache"] else 0.0)
    return {"metric": "eager_allreduce_mbytes_sec",
            "value": results["fused_cached"], "unit": "MB/s",
            "vs_baseline": speedup, "configs": results,
            "num_tensors": num_tensors, "elems": elems, "device": device,
            "card": hardware.card_line() if device.startswith("cuda")
            else None}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tensors", type=int, default=128)
    ap.add_argument("--elems", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        print(hardware.card_line(), flush=True)
    print(json.dumps(run(args.device, args.tensors, args.elems,
                         args.repeats)), flush=True)


if __name__ == "__main__":
    main()
