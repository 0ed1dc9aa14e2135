"""Device-time breakdown of horovod_tpu_torch's serving path on one card.

    python3 chip_profile.py

Builds the full-width flagship transformer of chip_smoke.py (random
weights from seed 0), warms one prefill of 8 x 512 prompt tokens and two
decode steps, then records one prefill and 8 decode steps under
``torch.profiler`` and prints, for each: the wall time, the device time
summed over kernels, the device's busy share (kernel time over wall
time), and the kernel time grouped by kind. Needs a CUDA card; fails
when the profiler records no kernel time.
"""

import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import FLAGSHIP, N_REQUESTS, NEW_TOKENS, PAGE_SIZE, prompts

DECODE_STEPS = 8

# Kernel-name fragments -> group, first match wins.
GROUPS = (
    ("flash_fwd", "flash_fwd (hand kernel)"),
    ("gemm", "matmul (cuBLAS)"),
    ("gemv", "matmul (cuBLAS)"),
    ("xmma", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("index", "gather/scatter"),
    ("scatter", "gather/scatter"),
    ("gather", "gather/scatter"),
    ("reduce", "reductions (norm, softmax, max)"),
    ("softmax", "reductions (norm, softmax, max)"),
    ("copy", "dtype casts and copies"),
    ("elementwise", "elementwise"),
    ("cat", "elementwise"),
)


def kernel_times(prof):
    """{kernel name: device microseconds} of one profile: the rows of
    device events only (an operator's row also carries its kernels'
    time, which would count them twice)."""
    out = {}
    for row in prof.key_averages():
        if row.device_type != DeviceType.CUDA:
            continue
        t = getattr(row, "self_device_time_total", None)
        if t is None:
            t = row.self_cuda_time_total
        if t > 0:
            out[row.key] = out.get(row.key, 0.0) + t
    return out


def report(label, prof, wall_s, where):
    times = kernel_times(prof)
    if not times:
        raise RuntimeError("chip_profile: the profiler recorded no kernel "
                           "time")
    total_us = sum(times.values())
    groups = {}
    for name, t in times.items():
        low = name.lower()
        group = next((g for frag, g in GROUPS if frag in low), "other")
        groups[group] = groups.get(group, 0.0) + t
    print(f"{label} [{where}]: wall {wall_s * 1e3:.2f} ms, device "
          f"{total_us / 1e3:.2f} ms, busy {total_us / 1e6 / wall_s:.3f}",
          flush=True)
    for group, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group}: {t / 1e3:.2f} ms ({t / total_us:.3f})")
    for name, t in sorted(times.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {t / 1e3:8.2f} ms  {name[:100]}")


def main():
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA card", file=sys.stderr)
        return 2
    where = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {where}", flush=True)

    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.serve.engine import ServeEngine

    _build.build()
    card = torch.device("cuda")
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **FLAGSHIP)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), card)
    eng = ServeEngine(params, cfg, page_size=PAGE_SIZE, device=card)
    ids = list(range(N_REQUESTS))
    for sid in ids:
        eng.cache.allocate(sid, len(prompts(cfg.vocab_size)[0]) + NEW_TOKENS)
    batch = prompts(cfg.vocab_size)
    length = len(batch[0])

    def decode(step):
        eng.decode(ids, np.full(N_REQUESTS, 7), [length + step] * N_REQUESTS)

    eng.prefill(ids, batch)
    decode(0)
    decode(1)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.prefill(ids, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report("prefill 8 x 512", prof, wall, where)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(DECODE_STEPS):
            decode(step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"decode {DECODE_STEPS} steps x 8 rows", prof, wall, where)
    return 0


if __name__ == "__main__":
    sys.exit(main())
