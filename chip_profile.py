"""Device-time breakdown of horovod_tpu_torch's serving and training
paths on one card.

    python3 chip_profile.py

Builds the full-width flagship transformer of chip_smoke.py (random
weights from seed 0). Serving: warms one prefill of 8 x 512 prompt
tokens and two decode steps, then records one prefill and 8 decode
steps. Training: ``hvd.init()``, ``DistributedOptimizer(AdamW)`` and the
batch of chip_smoke.py (4 x 4096, loss_chunk 512); warms one step, then
records one. The sequence-parallel step likewise: chip_smoke.py's SP
model (window 4096, a local ring of 4) at batch 2 x 8192. ResNet-50 as
chip_smoke.py's phase_resnet trains it (bf16, channels_last, batch 256
x 224^2, SGD(0.01) under ``DistributedOptimizer``); warms one step, then
records one. The band
tiles' forward runs the same kernel as the static one (``flash_fwd``
at an offset), on the tensor-core route (``flash_fwd_wgmma_kernel``)
as on the loop, so the profile counts them together; the band backward
kernels write f32 and show as their own instantiations, on the
tensor-core route (``*_wgmma_kernel``) as on the loop. For each
record it prints the wall time, the device time summed over kernels,
the device's busy share (kernel time over wall time), and the kernel
time grouped by kind. Needs a CUDA card; fails
when the profiler records no kernel time.
"""

import gc
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (ADAMW, FLAGSHIP, LOSS_CHUNK, N_REQUESTS, NEW_TOKENS,
                        PAGE_SIZE, RESNET_BATCH, RESNET_SIZE, SP_BATCH,
                        SP_MODEL, SP_RING, SP_SEQ, TRAIN_BATCH, TRAIN_SEQ,
                        prompts)

DECODE_STEPS = 8

# Kernel-name fragments -> group, first match wins. The backward kernels'
# templates name their output type first on the tensor-core route
# (float: the band kernels) and second on the loop (<input, output, D>).
GROUPS = (
    ("flash_fwd_wgmma_kernel",
     "flash_fwd (hand kernel, wgmma; static and band tiles)"),
    ("flash_fwd", "flash_fwd (hand kernel, loop; static and band tiles)"),
    ("flash_bwd_dq_wgmma_kernel<float", "flash_band_dq (hand kernel, wgmma)"),
    ("flash_bwd_dkv_wgmma_kernel<float",
     "flash_band_dkv (hand kernel, wgmma)"),
    ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq (hand kernel, wgmma)"),
    ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv (hand kernel, wgmma)"),
    ("flash_bwd_dq_kernel<__nv_bfloat16, float",
     "flash_band_dq (hand kernel, loop)"),
    ("flash_bwd_dkv_kernel<__nv_bfloat16, float",
     "flash_band_dkv (hand kernel, loop)"),
    ("flash_bwd_dq", "flash_bwd_dq (hand kernel, loop)"),
    ("flash_bwd_dkv", "flash_bwd_dkv (hand kernel, loop)"),
    ("nccl", "all-reduce (NCCL)"),
    # cuDNN's convolution kernels (forward, data and weight gradients)
    ("fprop", "convolution (cuDNN)"),
    ("dgrad", "convolution (cuDNN)"),
    ("wgrad", "convolution (cuDNN)"),
    ("conv", "convolution (cuDNN)"),
    ("pool", "pooling"),
    ("multi_tensor", "optimizer (AdamW foreach)"),
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
    del eng, params
    torch.cuda.empty_cache()
    profile_train(card, where)
    profile_train(card, where, sp=True)
    profile_resnet(card, where)
    return 0


def profile_resnet(card, where):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet50

    hvd.init(device=card)
    model = ResNet50(generator=torch.Generator().manual_seed(0),
                     device=card).to(memory_format=torch.channels_last)
    model.train()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE), dtype=np.float32)).to(
        card, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    labels = torch.from_numpy(rng.integers(0, 1000, RESNET_BATCH)).to(card)

    def step():
        opt.zero_grad(set_to_none=True)
        torch.nn.functional.cross_entropy(model(images), labels).backward()
        opt.step()

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"resnet50 train step {RESNET_BATCH} x {RESNET_SIZE}^2", prof,
           wall, where)
    del opt, model, images
    gc.collect()
    hvd.shutdown()
    torch.cuda.empty_cache()


def profile_train(card, where, sp=False):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel.ring_attention import RingAxis

    hvd.init(device=card)
    model, batch, seq, axes = FLAGSHIP, TRAIN_BATCH, TRAIN_SEQ, None
    if sp:
        model, batch, seq = SP_MODEL, SP_BATCH, SP_SEQ
        axes = tfm.ShardAxes(sp=RingAxis.local(SP_RING))
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **model)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card, axes=axes)
    hvd.broadcast_parameters(lm.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), **ADAMW),
        named_parameters=lm.named_parameters())
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (batch, seq))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)

    def step():
        opt.zero_grad(set_to_none=True)
        lm.loss(tokens, targets).backward()
        opt.step()

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    label = f"{'sp ' if sp else ''}train step {batch} x {seq}"
    report(label, prof, wall, where)
    del opt, lm
    gc.collect()
    hvd.shutdown()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
