"""Device-time breakdown of horovod_tpu_torch's serving and training
paths on one card.

    python3 chip_profile.py

Builds the full-width flagship transformer of chip_smoke.py (random
weights from seed 0). Serving, once eagerly (HOROVOD_STEP_PROGRAM=0) and
once through the engine's CUDA graphs: warms one prefill of 8 x 512
prompt tokens and two decode steps (capturing the graphs), then records
one prefill and 8 decode steps. Training: ``hvd.init()``, ``DistributedOptimizer(AdamW)`` and the
batch of chip_smoke.py (4 x 4096, loss_chunk 512); warms one step, then
records one. The sequence-parallel step likewise: chip_smoke.py's SP
model (window 4096, a local ring of 4) at batch 2 x 8192. flagship-moe
(chip_smoke.py's MOE_MODEL: MoE FFNs in layers 1, 3, 5 and 7, 8
experts, top-2) likewise at 4 x 4096, with the expert keys on the
exchange; then one MoE layer's forward and backward, and one dense
FFN's, timed alone at the step's shape (bf16 rows of 4 x 4096, CUDA
events, mean of 3), and the MoE layers' share of the step's device time
(4 MoE layers' time over the step's); and its serving round through the
graphs (full capacity). ResNet-50 as
chip_smoke.py's phase_resnet trains it (bf16, channels_last, batch 256
x 224^2, SGD(0.01) under ``DistributedOptimizer``); warms one step, then
records one; then times the host's launch of that step as a CUDA graph
(``compiled_train_step``) with 0 to 3 launches of it queued. The band
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
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (ADAMW, FLAGSHIP, LOSS_CHUNK, MOE_EXPERT_KEYS,
                        MOE_MODEL, N_REQUESTS, NEW_TOKENS, PAGE_SIZE,
                        RESNET_BATCH, RESNET_SIZE, SP_BATCH, SP_MODEL,
                        SP_RING, SP_SEQ, TRAIN_BATCH, TRAIN_SEQ, prompts)

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
    return total_us / 1e3


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
    for mode, value in (("eager", "0"), ("graphs", "1")):
        os.environ["HOROVOD_STEP_PROGRAM"] = value
        profile_serve(ServeEngine, params, cfg, card, f"{where}, {mode}")
    os.environ.pop("HOROVOD_STEP_PROGRAM")
    del params
    torch.cuda.empty_cache()
    profile_train(card, where)
    profile_train(card, where, sp=True)
    profile_train(card, where, moe=True)
    moe_cfg = tfm.TransformerConfig(dtype=torch.bfloat16,
                                    attention_impl="flash", **MOE_MODEL)
    params = tfm.init_params(moe_cfg, torch.Generator().manual_seed(0), card)
    os.environ["HOROVOD_STEP_PROGRAM"] = "1"
    profile_serve(ServeEngine, params, moe_cfg, card,
                  f"{where}, graphs, flagship-moe")
    os.environ.pop("HOROVOD_STEP_PROGRAM")
    del params
    torch.cuda.empty_cache()
    profile_resnet(card, where)
    return 0


def profile_serve(ServeEngine, params, cfg, card, where):
    """One prefill and DECODE_STEPS decode steps after a warm-up (which
    also captures the graphs when the engine takes them)."""
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

    # The same step as one CUDA graph: the host time of a replay's launch
    # with 0, 1, 2 and 3 launches of it still queued, beside its device
    # time (what bench.resnet's python_overhead_ms reads with two steps
    # in flight).
    step = hvd.compiled_train_step(
        lambda x, y: torch.nn.functional.cross_entropy(model(x), y), opt)
    for _ in range(2):  # warm-up and capture, then a replay
        step(images, labels)
    torch.cuda.synchronize()
    prog = next(iter(hvd.runtime.live_state().programs._programs.values()))
    launch_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        prog()
        launch_ms.append((time.perf_counter() - t0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    prog()
    end.record()
    torch.cuda.synchronize()
    print(f"resnet50 compiled step {RESNET_BATCH} x {RESNET_SIZE}^2 "
          f"[{where}]: replay launch on the host "
          f"{' / '.join(f'{t:.3f}' for t in launch_ms)} ms with 0 / 1 / 2 / "
          f"3 launches queued; one replay {start.elapsed_time(end):.2f} ms "
          f"on the card", flush=True)
    del step, prog, opt, model, images
    gc.collect()
    hvd.shutdown()
    torch.cuda.empty_cache()


def profile_train(card, where, sp=False, moe=False):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel.ring_attention import RingAxis

    hvd.init(device=card)
    model, batch, seq, axes = FLAGSHIP, TRAIN_BATCH, TRAIN_SEQ, None
    if moe:
        model = MOE_MODEL
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
        named_parameters=lm.named_parameters(),
        expert_keys=MOE_EXPERT_KEYS if moe else None)
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
    label = (f"{'sp ' if sp else 'moe ' if moe else ''}train step {batch} "
             f"x {seq}")
    step_ms = report(label, prof, wall, where)
    del opt  # its gradient hooks would count the timed passes below
    gc.collect()
    if moe:
        ffn_share(tfm, lm.params, cfg, batch, seq, step_ms, card, where)
    del lm
    gc.collect()
    hvd.shutdown()
    torch.cuda.empty_cache()


def ffn_share(tfm, params, cfg, batch, seq, step_ms, card, where):
    """One MoE layer's and one dense FFN's forward and backward (the
    block with its norm and residual, bf16 rows of batch x seq) timed
    alone with CUDA events, and the MoE layers' share of a step's
    device time ``step_ms``."""
    def fwd_bwd(layer):
        x = torch.randn(batch, seq, cfg.d_model, device=card,
                        dtype=cfg.dtype, requires_grad=True)
        g = torch.randn(batch, seq, cfg.d_model, device=card)

        def run():
            # an MoE layer's load-balance loss joins its output's gradient
            y, aux = tfm._mlp_block(params["layers"][layer], x, cfg)
            (y.float() + aux).backward(g)

        run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 3

    moe_ms, dense_ms = fwd_bwd(cfg.moe_layers[0]), fwd_bwd(0)
    n_moe = len(cfg.moe_layers)
    print(f"moe layer forward + backward at {batch} x {seq} [{where}]: "
          f"{moe_ms:.2f} ms, a dense FFN's {dense_ms:.2f} ms; the "
          f"{n_moe} MoE layers {n_moe * moe_ms:.2f} ms of a {step_ms:.2f} "
          f"ms step's device time ({n_moe * moe_ms / step_ms:.3f})",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
