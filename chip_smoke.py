"""Smoke run of horovod_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device: a CUDA card is required; its name and power limit are
   printed as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port is compiled from the checkout
   (one nvcc per source, all at once) into build/horovod_tpu_torch/;
   each kernel's registers, spills and shared memory (nvcc's -Xptxas -v)
   and the count of HGMMA (wgmma) instructions in its SASS (cuobjdump
   -sass, where the toolkit has it; a tensor-core kernel without one
   fails the run) are printed, for both sources;
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the same tensors on the card, with stated tolerances. ``flash_fwd``
   at the serving prefill shape, the SP path's diagonal tile (B 2,
   S 2048, window 4096) and ragged, windowed, non-causal and f32 shapes;
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the training head shape
   (B 1, S 4096), the SP diagonal tile with lse and delta strided as the
   ring's chunks are, and ragged causal, windowed, non-causal MHA and f32
   shapes. Every kernel, forward and backward, takes the tensor-core
   route on bf16 at D 64 or 128 and the CUDA-core loop elsewhere (the
   f32 shapes), as ``tensor_core_route`` says, and each shape checks
   that it took the route the rule gives. Each kernel, its plain version
   and one PyTorch library call computing the same function are timed at
   the shape its main path gives it (the plain backward at B 1: at B 4 it
   would materialize 4.3 GB score matrices);
4. parity: the serve engine's prefill logits through the flash kernel
   against the same prompts through ``attention_impl="dense"`` at full
   width, and a small f32 model's prefill + decode against its forward;
   then ``loss_fn``'s loss and every parameter gradient through flash
   against dense, at full width (B 1, S 1024) and on a small f32 model;
5. serve (main path 1): the flagship transformer of bench_transformer.py
   at full width (8 layers, the bench's own depth; d_model 2048, 16 query
   / 4 KV heads, d_ff 8192, vocab 32768, rope, bf16 activations, f32
   parameters, random weights from seed 0) serves 8 greedy requests of
   512 prompt tokens and 64 new tokens through ``serve.Engine``;
6. train (main path 2): the same model, as bench_transformer.py trains
   it (batch 4 x seq 4096, loss_chunk 512, AdamW 3e-4 with weight decay
   1e-4), through ``hvd.init()`` (NCCL, one rank),
   ``broadcast_parameters`` and ``DistributedOptimizer``: one warm-up
   step and 4 timed steps on one batch. The loss must fall, and the
   launches and exchanges must be as many as the steps say;
7. band kernels: ``flash_band_fwd``, ``flash_band_dq`` and
   ``flash_band_dkv`` against their plain versions at the ring's shapes
   (B 2, S 2048, H 16, H_kv 4, D 128, bf16, offsets 2048 and 4096, window
   4096; lse and delta strided as the ring's chunks are) and at small
   ragged f32 shapes with rows that see no key; each
   kernel, its plain version and SDPA with an explicit band mask timed at
   both offsets;
8. sequence-parallel parity: one step's loss and gradients of the
   flagship at max_seq 8192 and Mistral-7B's sliding window 4096 over a
   local ring of 4 against the same model without sequence parallelism
   (``flash_attention`` at the same window) on one batch of 2 x 8192, and
   a small f32 model's ring against dense attention;
9. SP train (main path 3): that model, through ``ShardAxes(sp=
   RingAxis.local(4))``, trained as in 6 at batch 2 x 8192 (2048 tokens
   a shard): 40 launches of each band kernel and 32 of each static kernel
   a step, checked exactly;
10. resnet (main path 4): ResNet-50 as bench.py trains it. Its f32
   forward at batch 2 on the card (TF32 off for cuDNN) against the same
   weights on the CPU; then the bf16 model, channels_last, at batch 256
   x 224^2 through ``hvd.init()``, ``broadcast_parameters`` and
   ``DistributedOptimizer(SGD(0.01))``: the batch-norm running statistics
   after one step against Flax's rule (biased variance, momentum 0.9)
   computed from each layer's input, 5 more steps with a falling loss,
   one all-reduce per bucket a step, img/s and MFU. Its convolutions run
   on cuDNN (the reference has none of its own), so it launches none of
   the kernels above;
11. bench: ``python -m horovod_tpu_torch.bench.resnet`` in its
   ``HOROVOD_BENCH_SMOKE=1`` shrink (its compiled-step and serve rows
   checked for no fallback and their cache hit rates) and ``python -m
   horovod_tpu_torch.bench.transformer --iters 2``, each line checked for
   its metric, a positive value and a numeric MFU.

The hot loop's CUDA graphs (ops/step_program.py) have two phases of
their own, each after the eager phase it mirrors; the eager serve phase
(5) runs with ``HOROVOD_STEP_PROGRAM=0``:

- compiled serve (main path 5, after 5): the serving workload through
  ``serve.Engine`` with graph-replayed prefill and decode beside the same
  engine run eagerly in this call (tokens identical, steady decode hit
  rate >= 0.9, no fallback; decode step, prefill, token latency p50/p99,
  TTFT and the card's busy share of a round, each beside the eager
  figure), then ``generate`` on the flagship: its graph-replayed greedy
  tokens equal the eager ``decode_step``'s argmax, whose logits lie within
  LOGITS_ATOL of a full forward over the same prefix;
- compiled train (main path 6, after 6): the flagship at 4 x 4096
  through ``compiled_train_step`` with capturable AdamW: parameters after
  3 steps bitwise equal to the same optimizer's eager run, 1 cache miss
  and 0 fallbacks, per replay 8 launches of each static kernel on the
  tensor-core route and one ``allreduce_jit`` a bucket, and the replay's
  time beside the eager step's.

The kernels phases also run the CUDA-core loop at head dim 256 against
the plain versions and time it (off every main path).

On every main path each kernel launch takes the tensor-core route: the
loop's counters stay at 0 there, and the route's counters are exact (8
``flash_fwd`` a prefill, replayed or not; 8 of each static kernel a
data-parallel step, replayed or not; 32 static and 40 band of each an SP
step). A graph's replay counts the launches its capture recorded.

Each main path runs with the kernel launch counts zeroed just before it
and read just after. The first line is the card's name and power limit
as ``nvidia-smi`` gives them; the run's wall time is printed before the
last two lines, which are
``{"kernels": [...]}``, one entry per kernel, and the result,
``{"ok": true, "device": {...}}``.
"""

import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s of
# the bf16 tensor cores and of f32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FLAGSHIP = dict(vocab_size=32768, d_model=2048, n_heads=16, n_kv_heads=4,
                n_layers=8, d_ff=8192, max_seq=4096, positional="rope")
N_REQUESTS, PROMPT_LEN, NEW_TOKENS, PAGE_SIZE = 8, 512, 64, 16
# bench_transformer.py's training defaults: batch per chip, sequence,
# loss chunk, optax.adamw(3e-4) (weight decay 1e-4, betas, eps).
TRAIN_BATCH, TRAIN_SEQ, LOSS_CHUNK = 4, 4096, 512
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
WARMUP_STEPS, TIMED_STEPS = 1, 4
# Sequence parallelism: a local ring of 4 on one card, Mistral-7B's
# sliding window, 2 x 8192 tokens a step (the 16,384 of the step above).
SP_RING, SP_BATCH, SP_SEQ, SP_WINDOW = 4, 2, 8192, 4096
SP_SHARD = SP_SEQ // SP_RING
# The ring's steps, 1 + ceil((window - 1) / shard), and its band tiles a
# layer: at step t the shards t..3 hold a live visiting tile at offset
# t * shard (the rest wrap into the future and launch nothing).
SP_STEPS = min(SP_RING, 1 + -(-(SP_WINDOW - 1) // SP_SHARD))
SP_BAND_OFFSETS = [t * SP_SHARD for t in range(1, SP_STEPS)
                   for _ in range(t, SP_RING)]
SP_MODEL = dict(FLAGSHIP, max_seq=SP_SEQ, attention_window=SP_WINDOW)

# Kernel vs plain version: f32 outputs differ by summation order only;
# a bf16 output by at most one rounding of a value below 4 (2^-6); lse
# is f32 on both sides. The forward's tensor-core route rounds p to bf16
# before p.v, and is held at these bands to the plain version that
# rounds it likewise (``operand_dtype=torch.bfloat16``), and to the f32
# plain version within ``fwd_bf16_rounding_bound`` B (p moved by at most
# 2^-8 of itself: 2^-8 of sum p|v| / l), element by element, plus the
# output's own rounding: half a bf16 ulp, at most OUT_ROUNDING of the
# unrounded value, which lies within B of the exact one.
F32_ATOL, BF16_ATOL, LSE_ATOL = 2e-5, 2e-2, 1e-4
OUT_ROUNDING = 2.0 ** -8
# Flash vs dense prefill logits at full width (bf16 activations): the
# two attention paths round differently (dense casts the normalised p to
# bf16 before p.v; flash rounds p against its running max, and divides
# by the l it summed in f32), and 8 layers carry that into logits of
# magnitude up to ~5 (0.0375 observed on an H100).
LOGITS_ATOL = 0.15
# A small f32 model: serve prefill + decode against its own forward.
SMALL_ATOL = 1e-4
# Backward kernels vs plain versions: f32 gradients are sums over a
# whole row or column of the score matrix, in another order (1e-4, the
# reference's gradient band); a bf16 gradient may differ by one bf16
# rounding (2^-7 relative) of its largest magnitude.
GRAD_F32_ATOL, GRAD_BF16_REL = 1e-4, 2.0 ** -7
# The tensor-core route rounds P and dS to bf16 before the second
# products, and is held to the plain version that rounds them likewise
# (``operand_dtype=torch.bfloat16``): the static kernels at
# GRAD_BF16_REL, and the band kernels' f32 gradients, which the loop
# held to GRAD_F32_ATOL, at BAND_BF16_REL of their largest magnitude: a
# P or dS value whose f32 sum came in another order can round to the
# neighbouring bf16 value, moving its terms by one bf16 ulp (2^-7).
# Against the f32 plain version each route's gradient holds within
# ``bf16_rounding_bound`` (P and dS each moved by at most 2^-8 of
# itself: 2^-8 of the same sums over absolute values) plus the band
# above: GRAD_BF16_REL of the largest magnitude for a bf16 gradient,
# GRAD_F32_ATOL for an f32 one.
BAND_BF16_REL = 2.0 ** -7
# Training parity, flash vs dense: the loss, and each parameter gradient
# by relative L2 difference; a small f32 model to the reference's 1e-4.
# Dense rounds the normalised p to bf16 before p.v, and the transpose of
# that cast rounds dP to bf16 before dS = P * (dP - delta), which
# cancels. The kernels round p against the running max in the forward
# and P and dS in the backward, each at another place than dense; dP
# stays f32. That puts single leaves at 0.02 (0.02118 at layers.7.wq on
# an H100), so the band is 3e-2. The f32 dense model is the yardstick of
# both bf16 paths: flash may be no farther from it than YARDSTICK_RATIO
# times the dense path is (worst leaf against worst leaf; 0.02272
# against 0.01912, a ratio of 1.188, on an H100).
TRAIN_LOSS_ATOL, TRAIN_GRAD_REL, SMALL_GRAD_ATOL = 1e-2, 3e-2, 1e-4
YARDSTICK_RATIO = 1.5


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _demangle(names):
    """{mangled: readable} through c++filt where the machine has it."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return dict(zip(names, out.splitlines()))


def kernel_usage(fa, _build, source, log):
    """Print each kernel of ``source``'s registers, spills and shared
    memory from nvcc's -Xptxas -v ``log``, and the HGMMA (wgmma)
    instructions in its SASS (cuobjdump -sass, where the toolkit has it).
    A tensor-core kernel without HGMMA fails the run."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[name].update(stack=int(m[1]), spill_stores=int(m[2]),
                               spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m[1])
            smem = re.search(r"(\d+) bytes smem", line)
            usage[name]["static_smem"] = int(smem[1]) if smem else 0
    hgmma = None
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass",
                               str(_build.library_path(source))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        hgmma = {}
        for part in sass.split("Function : ")[1:]:
            hgmma[part.split()[0]] = part.count("HGMMA")
    readable = _demangle(sorted(usage))
    for mangled in sorted(usage, key=lambda n: readable[n]):
        u, text = usage[mangled], readable[mangled]
        wgmma = "wgmma_kernel" in text
        d = 128 if re.search(r"[<, ]128>|Li128E", text) else 64
        kind = "flash_fwd" if "flash_fwd" in text else (
            "flash_bwd_dkv" if "dkv" in text else "flash_bwd_dq")
        dyn = fa.wgmma_smem_bytes(kind, d) if wgmma else None
        n = None if hgmma is None else hgmma.get(mangled, 0)
        short = re.search(r"flash_\w+(<[^>]*>)?", text)
        print(f"build {source} kernel {short[0] if short else text}: "
              f"{u.get('registers')} registers, {u.get('spill_stores')} "
              f"bytes spill stores, {u.get('spill_loads')} bytes spill "
              f"loads, {u.get('stack')} bytes stack, static smem "
              f"{u.get('static_smem')} bytes"
              + (f", dynamic smem {dyn} bytes" if wgmma else "")
              + ("; SASS not read (no cuobjdump)" if n is None
                 else f"; {n} HGMMA in its SASS"), flush=True)
        check(not wgmma or n is None or n > 0,
              f"{text}: a tensor-core kernel without HGMMA")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Device time of one call of ``fn``: the self time of the CUDA
    kernels it launches, summed by torch.profiler over ``iters`` calls.
    Where the host's enqueueing is slower than the kernels (a wrapper
    call at a small shape), ``time_ms`` measures the host instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(r, "self_device_time_total", 0)
             for r in prof.key_averages() if r.device_type == DeviceType.CUDA)
    return us / iters / 1e3


def attention_work(b, s, h, h_kv, d, dtype, causal, window):
    """(bytes, flops) one attention forward must move and do on these
    shapes: q, k, v read once, out and the f32 lse written once; 4*D
    FLOPs per (query, key) pair the mask keeps."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * s * h * d + 2 * b * s * h_kv * d) * itemsize \
        + 4 * b * h * s
    if not causal:
        pairs = s * s
    else:
        w = s if window is None else min(window, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    return nbytes, 4 * d * pairs * b * h


def hold_forward(fa, name, out, lse, args, extra, bound_args, rows=None):
    """Hold one forward kernel's (out, lse) on ``rows`` (None: all) to the
    plain version of the route it took, and on the tensor-core route also
    to the f32 plain version, at the bands of the header. ``extra``
    follows q, k, v in the plain version's call, ``bound_args`` in
    ``fwd_bf16_rounding_bound``'s. Returns (error against the route's
    plain version, against the f32 one (0 on the loop), route, report)."""
    tc = fa.tensor_core_route(*args)
    ref = getattr(fa, name + "_reference")
    rows = slice(None) if rows is None else rows
    want, want_lse = ref(*args, *extra,
                         operand_dtype=torch.bfloat16 if tc else None)
    tol = BF16_ATOL if args[0].dtype == torch.bfloat16 else F32_ATOL
    err = (out[:, rows].float() - want[:, rows].float()).abs().max().item()
    err_lse = (lse[:, :, rows] - want_lse[:, :, rows]).abs().max().item()
    text = (f"out max|d|={err:.3g} (tol {tol:g}), lse {err_lse:.3g} (tol "
            f"{LSE_ATOL:g})")
    check(err <= tol and err_lse <= LSE_ATOL,
          f"{name} disagrees with its plain version")
    err32 = 0.0
    if tc:
        exact = ref(*args, *extra)[0][:, rows].float()
        bound = fa.fwd_bf16_rounding_bound(*args, *bound_args)
        diff = (out[:, rows].float() - exact).abs()
        err32 = diff.max().item()
        text += (f"; f32 plain {err32:.3g} (tol {bound:.3g} + 2^-8 |out| "
                 f"an element)")
        check(bool((diff <= (1 + OUT_ROUNDING) * bound
                    + OUT_ROUNDING * exact.abs()).all()),
              f"{name} is farther from the f32 plain version than the "
              f"bf16 rounding of p allows")
    return err, err32, tc, text


def phase_kernels(fa, card, gen):
    """Kernel vs plain version at every listed shape (the training shape
    at B 1, for the plain version's memory); timings at the prefill
    shape. Returns the kernel's entry for the kernels line."""
    cases = [  # (B, S, H, H_kv, D, dtype, causal, window)
        (8, PROMPT_LEN, 16, 4, 128, torch.bfloat16, True, None),  # prefill
        (1, TRAIN_SEQ, 16, 4, 128, torch.bfloat16, True, None),  # training
        (SP_BATCH, SP_SHARD, 16, 4, 128, torch.bfloat16, True,
         SP_WINDOW),                                    # SP diagonal tile
        (2, 1000, 16, 4, 128, torch.bfloat16, True, None),        # ragged
        (2, 1000, 16, 4, 128, torch.bfloat16, True, 256),         # window
        (2, 700, 8, 8, 64, torch.bfloat16, False, None),          # non-causal
        (2, 130, 4, 2, 8, torch.float32, True, None),             # small f32
        (2, 300, 4, 2, 256, torch.bfloat16, True, None),          # D 256
        (1, 200, 4, 1, 256, torch.float32, True, 50),     # D 256, window
    ]
    worst = worst32 = 0.0
    entry = None
    for b, s, h, h_kv, d, dtype, causal, window in cases:
        q = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
        k = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
        v = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
        before = read_launches(fa)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal, window)
        torch.cuda.synchronize()
        err, err32, tc, text = hold_forward(
            fa, "flash_attention", out, lse, (q, k, v), (causal, window),
            (causal, window))
        check(tc == (dtype == torch.bfloat16 and d in (64, 128)),
              f"flash_fwd took the wrong route at {(b, s, h, d, dtype)}")
        route = "flash_fwd_wgmma" if tc else "flash_fwd"
        check(read_launches(fa)[route] == before[route] + 1,
              f"flash_fwd was not counted on its route at {(b, s, h, d)}")
        print(f"kernel flash_fwd B={b} S={s} H={h} H_kv={h_kv} D={d} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"[{'tensor cores' if tc else 'loop'}]: {text}", flush=True)
        worst, worst32 = max(worst, err), max(worst32, err32)
        if entry is not None:
            continue
        # The prefill shape: the one the main path gives the kernel.
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal, window),
                     50)
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(
                q, k, v, causal, window, operand_dtype=torch.bfloat16), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        library_ms = time_ms(sdpa, 50)
        # the wrapper call at this shape is host-bound: the kernels'
        # device times too
        dev_ms = device_ms(
            lambda: fa.flash_attention(q, k, v, causal, window), 50)
        library_dev_ms = device_ms(sdpa, 50)
        nbytes, flops = attention_work(b, s, h, h_kv, d, dtype, causal,
                                       window)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        entry = {
            "name": "flash_fwd", "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "horovod_tpu/ops/flash_attention.py:72",
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": library_ms,
            "device_ms": dev_ms, "library_device_ms": library_dev_ms,
        }
        print(f"kernel flash_fwd timing at the prefill shape: {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
              f"{flops / ms / 1e9:.1f} TFLOP/s); device time (profiler) "
              f"{dev_ms:.4f} ms, SDPA {library_dev_ms:.4f} ms", flush=True)
    entry["max_abs_err"] = worst
    entry["max_abs_err_f32_plain"] = worst32
    return entry


def prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, PROMPT_LEN).tolist()
            for _ in range(N_REQUESTS)]


def phase_parity(tfm, ServeEngine, params, card):
    """Full-width prefill logits through flash vs dense attention, and
    a small f32 model's serve path against its own forward."""
    ids = list(range(N_REQUESTS))
    logits = {}
    for impl in ("flash", "dense"):
        cfg = tfm.TransformerConfig(dtype=torch.bfloat16,
                                    attention_impl=impl, **FLAGSHIP)
        eng = ServeEngine(params, cfg, page_size=PAGE_SIZE, device=card)
        for sid in ids:
            eng.cache.allocate(sid, PROMPT_LEN + NEW_TOKENS)
        logits[impl] = eng.prefill(ids, prompts(cfg.vocab_size))
        del eng
    flash, dense = logits["flash"], logits["dense"]
    check(flash.shape == (N_REQUESTS, FLAGSHIP["vocab_size"])
          and np.isfinite(flash).all(), "prefill logits shape or finiteness")
    diff = float(np.abs(flash - dense).max())
    agree = float((flash.argmax(-1) == dense.argmax(-1)).mean())
    print(f"parity prefill logits flash vs dense (8 x 512, full width): "
          f"max|d|={diff:.4g} (tol {LOGITS_ATOL:g}), max|logit|="
          f"{float(np.abs(dense).max()):.3g}, argmax agreement {agree:.3f}",
          flush=True)
    check(diff <= LOGITS_ATOL, "flash and dense prefill logits disagree")

    small = tfm.TransformerConfig(
        vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=256, max_seq=64, dtype=torch.float32, positional="rope",
        attention_impl="flash")
    sp = tfm.init_params(small, torch.Generator().manual_seed(1), card)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 24))
    ref = tfm.forward(sp, torch.from_numpy(tokens).to(card), small)
    eng = ServeEngine(sp, small, num_pages=16, page_size=8, device=card)
    for sid in (0, 1):
        eng.cache.allocate(sid, 24)
    rows = [eng.prefill([0, 1], [tokens[0, :16].tolist(),
                                 tokens[1, :16].tolist()])]
    for i in range(16, 24):
        rows.append(eng.decode([0, 1], tokens[:, i], [i, i]))
    want = ref.cpu().numpy()[:, 15:24].transpose(1, 0, 2)
    small_diff = float(np.abs(np.stack(rows) - want).max())
    print(f"parity small f32 model, serve prefill+decode vs forward: "
          f"max|d|={small_diff:.3g} (tol {SMALL_ATOL:g})", flush=True)
    check(small_diff <= SMALL_ATOL, "serve path disagrees with forward")


@contextlib.contextmanager
def step_program(value):
    """HOROVOD_STEP_PROGRAM set to ``value`` ("0": programs run eagerly,
    "1": captured as CUDA graphs) while the block builds programs."""
    old = os.environ.get("HOROVOD_STEP_PROGRAM")
    os.environ["HOROVOD_STEP_PROGRAM"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("HOROVOD_STEP_PROGRAM")
        else:
            os.environ["HOROVOD_STEP_PROGRAM"] = old


def phase_serve(fa, serve, metrics, lm, card, where):
    """The main path: serve.Engine, 8 requests, counts zeroed around;
    every program eager (HOROVOD_STEP_PROGRAM=0), as before the graphs."""
    with step_program("0"):
        return _phase_serve(fa, serve, metrics, lm, card, where)


def _phase_serve(fa, serve, metrics, lm, card, where):
    engine = serve.Engine(lm, lm.params, page_size=PAGE_SIZE,
                          max_batch=N_REQUESTS, device=card)
    try:
        warm = engine.submit(prompts(lm.cfg.vocab_size)[0], 4)
        check(len(warm.result()) == 4, "warm-up request")
        engine.batcher.recent_ttft.clear()
        engine.batcher.recent_token_latency.clear()
        prefill_hist = metrics.SERVE_STEP_SECONDS.labels(phase="prefill")
        decode_hist = metrics.SERVE_STEP_SECONDS.labels(phase="decode")
        p0, d0 = prefill_hist.value(), decode_hist.value()

        zero_launches(fa)
        t0 = time.perf_counter()
        handles = [engine.submit(p, NEW_TOKENS)
                   for p in prompts(lm.cfg.vocab_size)]
        outs = [h.result() for h in handles]
        wall = time.perf_counter() - t0
        routes = read_launches(fa)
        launches = routes["flash_fwd_wgmma"]
    finally:
        engine.close()

    prefill_calls = prefill_hist.value()["count"] - p0["count"]
    decode_calls = decode_hist.value()["count"] - d0["count"]
    check(all(len(o) == NEW_TOKENS for o in outs),
          f"streams yielded {[len(o) for o in outs]} tokens")
    check(all(0 <= t < lm.cfg.vocab_size for o in outs for t in o),
          "token ids out of range")
    check(prefill_calls >= 1 and launches == lm.cfg.n_layers * prefill_calls,
          f"flash_fwd launched {launches} times on the tensor cores over "
          f"{prefill_calls} prefill calls of {lm.cfg.n_layers} layers")
    check(sum(routes.values()) == launches,
          f"serving launched other kernels or routes: {routes}")
    ttft = np.asarray(engine.batcher.recent_ttft) * 1e3
    tok = np.asarray(engine.batcher.recent_token_latency) * 1e3
    generated = sum(len(o) for o in outs)
    prefill_ms = (prefill_hist.value()["sum"] - p0["sum"]) / prefill_calls \
        * 1e3
    decode_ms = (decode_hist.value()["sum"] - d0["sum"]) / decode_calls * 1e3
    print(f"serve {N_REQUESTS} x ({PROMPT_LEN} + {NEW_TOKENS}) tokens "
          f"[{where}]: ttft p50 {np.percentile(ttft, 50):.2f} ms p99 "
          f"{np.percentile(ttft, 99):.2f} ms; token latency p50 "
          f"{np.percentile(tok, 50):.2f} ms p99 {np.percentile(tok, 99):.2f}"
          f" ms; {generated / wall:.1f} tokens/s", flush=True)
    print(f"serve steps [{where}]: {prefill_calls} prefill calls, mean "
          f"{prefill_ms:.2f} ms; {decode_calls} decode steps, mean "
          f"{decode_ms:.2f} ms; flash_fwd launches {launches} (tensor "
          f"cores)", flush=True)
    return routes


def serve_round(engine, metrics, vocab):
    """One round of the serving workload driven on this thread: the 8
    requests submitted, then the batcher drained. Returns the streams,
    the wall time and the round's TTFT, token latencies and mean prefill
    and decode step times (ms)."""
    b = engine.batcher
    b.recent_ttft.clear()
    b.recent_token_latency.clear()
    hists = {ph: metrics.SERVE_STEP_SECONDS.labels(phase=ph)
             for ph in ("prefill", "decode")}
    h0 = {ph: h.value() for ph, h in hists.items()}
    t0 = time.perf_counter()
    handles = [engine.submit(p, NEW_TOKENS) for p in prompts(vocab)]
    b.drain()
    wall = time.perf_counter() - t0
    out = {"outs": [list(h.request.generated) for h in handles],
           "wall_ms": wall * 1e3,
           "ttft": np.asarray(b.recent_ttft) * 1e3,
           "tok": np.asarray(b.recent_token_latency) * 1e3}
    for ph, h in hists.items():
        v = h.value()
        calls = v["count"] - h0[ph]["count"]
        out[f"{ph}_calls"] = calls
        out[f"{ph}_ms"] = (v["sum"] - h0[ph]["sum"]) / max(calls, 1) * 1e3
    return out


def phase_compiled_serve(fa, serve, metrics, tfm, lm, card, where):
    """Main path 5: the serving workload through graph-replayed prefill
    and decode, beside the same engine run eagerly in this call. Each
    engine serves the 8 requests three times from this thread: a round
    that builds its programs (the graphs' warm-up and capture), a timed
    round, and a round under torch.profiler for the device time, whose
    ratio to the timed round's wall is the card's busy share. The graph
    engine's tokens must equal the eager one's, its timed round must hit
    its program cache on >= 0.9 of the decode steps with no fallback,
    and its prefill replay launches flash_fwd 8 times. Then ``generate``
    on the flagship: its graph-replayed greedy tokens against the eager
    ``decode_step``'s argmax, whose logits must lie within LOGITS_ATOL of
    a full forward over the same prefix. Returns {kernel: launches} of
    the graph engine's timed round and of ``generate``."""
    vocab = lm.cfg.vocab_size
    res = {}
    for mode, value in (("eager", "0"), ("graphs", "1")):
        with step_program(value):
            engine = serve.Engine(lm, lm.params, page_size=PAGE_SIZE,
                                  max_batch=N_REQUESTS, start=False,
                                  device=card)
            se = engine.engine
            built = serve_round(engine, metrics, vocab)
            c0 = (se.decode_hits, se.decode_misses)
            zero_launches(fa)
            timed = serve_round(engine, metrics, vocab)
            timed["launches"] = read_launches(fa)
            hits, misses = (se.decode_hits - c0[0], se.decode_misses - c0[1])
            timed["steady_hit_rate"] = hits / max(hits + misses, 1)
            timed["device_ms"] = device_ms(
                lambda: serve_round(engine, metrics, vocab), 1)
            timed["busy"] = timed["device_ms"] / timed["wall_ms"]
            timed["built_outs"] = built["outs"]
            timed["captured"] = [p.captured
                                 for p in se._local_progs.values()]
            timed["fallback_steps"] = se.fallback_steps
            res[mode] = timed
            engine.close()
            del engine, se
            gc.collect()
            torch.cuda.empty_cache()
    eager, graphs = res["eager"], res["graphs"]
    check(graphs["captured"] and all(graphs["captured"])
          and not any(eager["captured"]),
          f"graph capture by engine: graphs {graphs['captured']}, eager "
          f"{eager['captured']}")
    check(graphs["outs"] == eager["outs"] == graphs["built_outs"]
          == eager["built_outs"],
          "graph-served tokens differ from the eager engine's")
    check(graphs["steady_hit_rate"] >= 0.9 and graphs["fallback_steps"] == 0,
          f"decode hit rate {graphs['steady_hit_rate']}, fallbacks "
          f"{graphs['fallback_steps']}")
    launches = graphs["launches"]
    check(graphs["prefill_calls"] >= 1 and launches["flash_fwd_wgmma"]
          == lm.cfg.n_layers * graphs["prefill_calls"]
          and sum(launches.values()) == launches["flash_fwd_wgmma"],
          f"graph serving launches {launches} over "
          f"{graphs['prefill_calls']} prefill replays")
    for mode, r in res.items():
        print(f"compiled serve [{mode}] {N_REQUESTS} x ({PROMPT_LEN} + "
              f"{NEW_TOKENS}) [{where}]: prefill {r['prefill_ms']:.2f} ms "
              f"({r['prefill_calls']} call); decode step "
              f"{r['decode_ms']:.2f} ms (mean of {r['decode_calls']}); "
              f"token latency p50 {np.percentile(r['tok'], 50):.2f} ms p99 "
              f"{np.percentile(r['tok'], 99):.2f} ms; ttft p50 "
              f"{np.percentile(r['ttft'], 50):.2f} ms; "
              f"{N_REQUESTS * NEW_TOKENS / r['wall_ms'] * 1e3:.1f} tokens/s; "
              f"device {r['device_ms']:.2f} ms of a {r['wall_ms']:.2f} ms "
              f"round, busy {r['busy']:.3f}", flush=True)
    print(f"compiled serve: tokens identical to eager; steady decode hit "
          f"rate {graphs['steady_hit_rate']:.3f}; decode step "
          f"{eager['decode_ms']:.2f} -> {graphs['decode_ms']:.2f} ms",
          flush=True)

    # generate on the flagship: graph-replayed decode against eager
    # decode_step and a full forward over the same prefix
    cfg, params = lm.cfg, lm.params
    gen_prompt, gen_new = 64, 16
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, vocab, (2, gen_prompt))).to(card)
    zero_launches(fa)
    with step_program("1"):
        out = tfm.generate(params, prompt, cfg, gen_new)
    gen_launches = read_launches(fa)
    total = gen_prompt + gen_new
    with torch.inference_mode():
        cache = tfm.init_cache(cfg, 2, total, device=card)
        logits, cache = tfm.prefill_cache(params, cache, out[:, :gen_prompt],
                                          cfg)
        rows = [logits]
        for i in range(gen_prompt, total - 1):
            logits, cache = tfm.decode_step(params, cache, out[:, i], cfg)
            rows.append(logits)
        rows = torch.stack(rows, dim=1)
        ref = tfm.forward(params, out[:, :total - 1], cfg)[:, gen_prompt - 1:]
    diff = float((rows - ref).abs().max())
    greedy = torch.equal(rows.argmax(-1), out[:, gen_prompt:])
    print(f"generate 2 x ({gen_prompt} + {gen_new}) on the flagship: "
          f"decode_step logits vs forward max|d|={diff:.4g} (tol "
          f"{LOGITS_ATOL:g}); graph tokens equal eager decode_step's argmax "
          f"{greedy}; launches {gen_launches}", flush=True)
    check(diff <= LOGITS_ATOL, "decode_step logits disagree with forward")
    check(greedy, "generate's graph tokens differ from eager decode_step's")
    check(gen_launches["flash_fwd_wgmma"] == cfg.n_layers
          and sum(gen_launches.values()) == cfg.n_layers,
          f"generate launches {gen_launches}: one prefill expected")
    return {k: launches[k] + gen_launches[k] for k in launches}


def causal_pairs(s, causal, window, off=0):
    """(query, key) pairs the mask keeps in one (b, h) row of a tile whose
    query row i sits at position off + i (0 <= off + i - j < window)."""
    if not causal:
        return s * s
    from horovod_tpu_torch.ops.flash_attention import band_key_span
    lo, hi = band_key_span(s, off, window)
    return int((hi - lo + 1).clamp(min=0).sum())


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def backward_work(b, s, h, h_kv, d, dtype, causal, window):
    """{kernel: (bytes, flops)} of the two backward kernels on these
    shapes. dq reads q, dO, k, v, lse and delta and writes dq, 6*D FLOPs
    per live pair (s, dp, dS.K); dkv reads the same and writes dk and
    dv, 8*D FLOPs per live pair (s, dp, P^T.dO, dS^T.Q)."""
    item = torch.tensor([], dtype=dtype).element_size()
    q_side = b * s * h * d * item
    kv_side = b * s * h_kv * d * item
    vectors = 2 * 4 * b * h * s
    pairs = causal_pairs(s, causal, window) * b * h
    return {
        "flash_bwd_dq": (3 * q_side + 2 * kv_side + vectors, 6 * d * pairs),
        "flash_bwd_dkv": (2 * q_side + 4 * kv_side + vectors, 8 * d * pairs),
    }


def bwd_inputs(fa, card, gen, b, s, h, h_kv, d, dtype, causal, window,
               shard=None):
    """q, k, v, dO in ``dtype`` and the forward's lse and delta. With
    ``shard`` i, lse and delta are the strided views of shard i of a
    (B, H, SP_RING * S) pair, as a chunk of the ring's lse is."""
    q = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
    k = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
    v = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
    do = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal, window)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if shard is not None:
        lse, delta = ring_view(lse, shard, gen), ring_view(delta, shard, gen)
    return q, k, v, do, lse, delta


def ring_view(x, shard, gen):
    """``x`` (B, H, S) as shard ``shard`` of a (B, H, SP_RING * S) tensor
    of random rows: the strided view that ``lse.chunk(SP_RING, dim=2)``
    gives ring attention's backward."""
    b, h, s = x.shape
    wide = torch.randn(b, h, SP_RING * s, generator=gen, device=x.device)
    wide[..., shard * s:(shard + 1) * s] = x
    view = wide.chunk(SP_RING, dim=2)[shard]
    check(not view.is_contiguous(), "a ring view is contiguous")
    return view


def _tuple(x):
    return (x,) if torch.is_tensor(x) else tuple(x)


def hold_backward(fa, name, got, args, extra, bound_args):
    """Hold one backward kernel's gradients ``got`` to the plain version
    of the route it took, and on the tensor-core route also to the f32
    plain version, at the bands of the header. ``extra`` follows the
    operands in the plain version's call, ``bound_args`` in
    ``bf16_rounding_bound``'s. Returns (worst error against the route's
    plain version, worst against the f32 one, route, report)."""
    tc = fa.tensor_core_route(*args[:4])
    ref = getattr(fa, name + "_reference")
    want = _tuple(ref(*args, *extra,
                      operand_dtype=torch.bfloat16 if tc else None))
    exact = _tuple(ref(*args, *extra)) if tc else want
    bound = fa.bf16_rounding_bound(*args, *bound_args) if tc else None
    outs = ("dq",) if name.endswith("dq") else ("dk", "dv")
    worst, worst32, text = 0.0, 0.0, []
    for out, g, w, x in zip(outs, got, want, exact):
        f32_out = g.dtype == torch.float32
        top = w.float().abs().max().item()
        if tc:
            tol = (BAND_BF16_REL if f32_out else GRAD_BF16_REL) * top
        else:
            tol = GRAD_F32_ATOL if f32_out else GRAD_BF16_REL * top
        err = (g.float() - w.float()).abs().max().item()
        text.append(f"{out} max|d|={err:.3g} (tol {tol:.3g})")
        check(err <= tol, f"{name} disagrees with its plain version")
        worst = max(worst, err)
        if tc:
            tol32 = bound["dq dk dv".split().index(out)] + (
                GRAD_F32_ATOL if f32_out else
                GRAD_BF16_REL * x.float().abs().max().item())
            err32 = (g.float() - x.float()).abs().max().item()
            text[-1] += f", f32 plain {err32:.3g} (tol {tol32:.3g})"
            check(err32 <= tol32,
                  f"{name} is farther from the f32 plain version than "
                  f"the bf16 rounding of P and dS allows")
            worst32 = max(worst32, err32)
    return worst, worst32, tc, "; ".join(text)


def phase_backward_kernels(fa, card, gen):
    """flash_bwd_dq and flash_bwd_dkv against their plain versions at
    every listed shape; the kernels and SDPA's backward timed at the
    training shape, the plain versions at B 1. Returns the two entries
    of the kernels line (launches filled in by the main paths)."""
    cases = [  # (B, S, H, H_kv, D, dtype, causal, window)
        (1, TRAIN_SEQ, 16, 4, 128, torch.bfloat16, True, None),  # training
        # the SP path's diagonal tile, lse and delta strided as the ring's
        (SP_BATCH, SP_SHARD, 16, 4, 128, torch.bfloat16, True, SP_WINDOW),
        (1, 1000, 16, 4, 128, torch.bfloat16, True, None),       # ragged
        (1, 1000, 16, 4, 128, torch.bfloat16, True, 256),        # window
        (1, 700, 8, 8, 64, torch.bfloat16, False, None),         # non-causal
        (2, 130, 4, 2, 8, torch.float32, True, None),            # small f32
        (2, 300, 4, 2, 256, torch.bfloat16, True, None),         # D 256
        (1, 200, 4, 1, 256, torch.float32, True, 50),    # D 256, window
    ]
    names = ("flash_bwd_dq", "flash_bwd_dkv")
    worst = dict.fromkeys(names, 0.0)
    worst32 = dict.fromkeys(names, 0.0)
    plain_ms = {}
    for i, (b, s, h, h_kv, d, dtype, causal, window) in enumerate(cases):
        args = bwd_inputs(fa, card, gen, b, s, h, h_kv, d, dtype, causal,
                          window, shard=1 if s == SP_SHARD else None)
        got = {"flash_bwd_dq": (fa.flash_bwd_dq(*args, causal, window),),
               "flash_bwd_dkv": fa.flash_bwd_dkv(*args, causal, window)}
        torch.cuda.synchronize()
        line = []
        for name in names:
            err, err32, tc, text = hold_backward(
                fa, name, got[name], args, (causal, window),
                (causal, window))
            check(tc == (dtype == torch.bfloat16 and d in (64, 128)),
                  f"{name} took the wrong route at {(b, s, h, d, dtype)}")
            line.append(text)
            worst[name] = max(worst[name], err)
            worst32[name] = max(worst32[name], err32)
        print(f"kernel backward B={b} S={s} H={h} H_kv={h_kv} D={d} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"[{'tensor cores' if tc else 'loop'}]: " + "; ".join(line),
              flush=True)
        if i == 0:
            # the plain version of the route the training shape takes
            plain_ms = {
                "flash_bwd_dq": time_ms(
                    lambda: fa.flash_bwd_dq_reference(
                        *args, True, None, operand_dtype=torch.bfloat16), 3),
                "flash_bwd_dkv": time_ms(
                    lambda: fa.flash_bwd_dkv_reference(
                        *args, True, None, operand_dtype=torch.bfloat16), 3),
            }
        del args, got
        torch.cuda.empty_cache()

    # The training shape: B 4, S 4096, as the main path gives it.
    shape = (TRAIN_BATCH, TRAIN_SEQ, 16, 4, 128, torch.bfloat16, True, None)
    args = bwd_inputs(fa, card, gen, *shape)
    ms = {"flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(*args), 5),
          "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(*args), 5)}
    fwd_ms = time_ms(lambda: fa.flash_attention(*args[:3]), 10)
    q, k, v = (x.transpose(1, 2).detach().requires_grad_()
               for x in args[:3])
    g = args[3].transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                    enable_gqa=True), 10)
    sdpa_both = time_ms(lambda: torch.autograd.grad(
        sdpa(q, k, v, is_causal=True, enable_gqa=True), (q, k, v), g), 10)
    library_ms = sdpa_both - sdpa_fwd
    fwd_bytes, fwd_flops = attention_work(*shape)
    print(f"kernel flash_fwd timing at the training shape (B 4, S 4096): "
          f"{fwd_ms:.4f} ms, SDPA forward {sdpa_fwd:.4f} ms, bound "
          f"{bound(fwd_bytes, fwd_flops, torch.bfloat16)[0]:.4f} ms "
          f"({fwd_flops / fwd_ms / 1e9:.1f} TFLOP/s)", flush=True)
    work = backward_work(*shape)
    entries = {}
    for name, replaces in (("flash_bwd_dq", 125), ("flash_bwd_dkv", 169)):
        bound_ms, bound_by = bound(*work[name], torch.bfloat16)
        entries[name] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"horovod_tpu/ops/flash_attention.py:{replaces}",
            "ms": ms[name], "plain_ms": plain_ms[name],
            "plain_shape": "B 1, S 4096 (the kernel's ms is at B 4)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention backward (forward + "
                       "backward less forward), dq, dk and dv together",
            "max_abs_err": worst[name],
            "max_abs_err_f32_plain": worst32[name],
        }
        print(f"kernel {name} timing at the training shape: {ms[name]:.4f} "
              f"ms, plain (B 1) {plain_ms[name]:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; "
              f"{work[name][1] / ms[name] / 1e9:.1f} TFLOP/s)", flush=True)
    print(f"kernel backward pair at the training shape: "
          f"{ms['flash_bwd_dq'] + ms['flash_bwd_dkv']:.4f} ms; SDPA backward "
          f"{library_ms:.4f} ms (forward + backward {sdpa_both:.4f} ms)",
          flush=True)
    train_fwd = {"ms": fwd_ms, "library_ms": sdpa_fwd,
                 "bound_ms": bound(fwd_bytes, fwd_flops, torch.bfloat16)[0]}
    del args, q, k, v, g
    torch.cuda.empty_cache()
    d256 = loop_d256_timings(fa, card, gen)
    train_fwd["loop_d256_ms"] = d256["flash_fwd"]
    for name in names:
        entries[name]["loop_d256_ms"] = d256[name]
    return entries, train_fwd


# Head dim 256 runs the CUDA-core loop only (off every main path): its
# times at B 1 x S 4096, H 8 / H_kv 2, bf16, causal.
D256_SHAPE = (1, TRAIN_SEQ, 8, 2, 256, torch.bfloat16, True, None)


def loop_d256_timings(fa, card, gen):
    """{kernel: ms} of the three static kernels at D256_SHAPE, each with
    its bound (operations, at the f32 rate: the loop multiplies on the
    CUDA cores)."""
    args = bwd_inputs(fa, card, gen, *D256_SHAPE)
    check(not fa.tensor_core_route(*args[:4]), "D 256 took the tensor cores")
    ms = {"flash_fwd": time_ms(lambda: fa.flash_attention(*args[:3]), 3),
          "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(*args), 3),
          "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(*args), 3)}
    work = backward_work(*D256_SHAPE)
    work["flash_fwd"] = attention_work(*D256_SHAPE)
    for name, t in ms.items():
        b_ms, by = bound(*work[name], torch.float32)
        print(f"kernel {name} on the loop at D 256 (B 1, S 4096, H 8/2, "
              f"bf16, causal): {t:.4f} ms, bound {b_ms:.4f} ms ({by}, f32 "
              f"rate; {work[name][1] / t / 1e9:.1f} TFLOP/s)", flush=True)
    del args
    torch.cuda.empty_cache()
    return ms


def band_work(b, s, h, h_kv, d, dtype, off, window):
    """{kernel: (bytes, flops)} of the three band kernels on these shapes:
    each input read once, each output written once (out in ``dtype``,
    lse and the gradients f32), 4, 6 and 8 x D FLOPs per live pair."""
    item = torch.tensor([], dtype=dtype).element_size()
    q_side, kv_side = b * s * h * d, b * s * h_kv * d
    vec = 4 * b * h * s
    pairs = causal_pairs(s, True, window, off) * b * h
    return {
        "flash_band_fwd": ((2 * q_side + 2 * kv_side) * item + vec,
                           4 * d * pairs),
        "flash_band_dq": ((2 * q_side + 2 * kv_side) * item + 2 * vec
                          + 4 * q_side, 6 * d * pairs),
        "flash_band_dkv": ((2 * q_side + 2 * kv_side) * item + 2 * vec
                           + 2 * 4 * kv_side, 8 * d * pairs),
    }


def live_rows(fa, s, off, window):
    """Rows of a band tile at offset ``off`` with at least one live key."""
    lo, hi = fa.band_key_span(s, off, window)
    return lo <= hi


def top_kernel(fn):
    """Name of the CUDA kernel with the most device time in one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(getattr(r, "self_device_time_total", 0), r.key)
            for r in prof.key_averages() if r.device_type == DeviceType.CUDA]
    return max(rows)[1][:90] if rows else "not measured"


def band_inputs(fa, card, gen, b, s, h, h_kv, d, dtype, off, window):
    """q, k, v, dO in ``dtype``; a finite global lse (the band tile's
    merged with a diagonal tile's, as the ring merges them) and
    delta = rowsum(dO * out) of the band tile's out. At the path's shard
    length, lse and delta are strided views, as the ring's chunks are."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=card).to(dtype)
    q, do = randn(b, s, h, d), randn(b, s, h, d)
    k, v, k2, v2 = (randn(b, s, h_kv, d) for _ in range(4))
    out, lse_band = fa.flash_band_fwd_reference(q, k, v, off, window)
    _, lse_diag = fa.flash_attention_reference(q, k2, v2, True, window)
    lse = torch.logaddexp(lse_band, lse_diag)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if s == SP_SHARD:
        shard = off // s
        lse, delta = ring_view(lse, shard, gen), ring_view(delta, shard, gen)
    return q, k, v, do, lse, delta


def phase_band_kernels(fa, card, gen):
    """The three band kernels against their plain versions at every
    listed shape; each timed with its plain version and SDPA (explicit
    band mask) at the ring's two offsets. Returns their entries of the
    kernels line: times are means per launch over the path's mix of
    offsets (SP_BAND_OFFSETS)."""
    path = (SP_BATCH, SP_SHARD, 16, 4, 128, torch.bfloat16)
    cases = [  # (B, S, H, H_kv, D, dtype, off, window)
        path + (SP_SHARD, SP_WINDOW),       # fully visible tile
        path + (2 * SP_SHARD, SP_WINDOW),   # half band, its last row dead
        (2, 130, 4, 2, 8, torch.float32, 130, 100),     # ragged, dead rows
        (1, 1000, 8, 8, 64, torch.float32, 2000, 1500),  # off 2S, dead rows
        (1, 700, 16, 4, 128, torch.bfloat16, 700, 1000),  # ragged, window > S
    ]
    names = ("flash_band_fwd", "flash_band_dq", "flash_band_dkv")
    worst = dict.fromkeys(names, 0.0)
    worst32 = dict.fromkeys(names, 0.0)
    timed = {}
    for b, s, h, h_kv, d, dtype, off, window in cases:
        q, k, v, do, lse, delta = band_inputs(fa, card, gen, b, s, h, h_kv,
                                              d, dtype, off, window)
        before = read_launches(fa)
        out, lse_t = fa.flash_band_fwd(q, k, v, off, window)
        torch.cuda.synchronize()
        after = read_launches(fa)
        dq = fa.flash_band_dq(q, k, v, do, lse, delta, off, window)
        dk, dv = fa.flash_band_dkv(q, k, v, do, lse, delta, off, window)
        torch.cuda.synchronize()
        live = live_rows(fa, s, off, window).to(card)
        check(torch.isfinite(out).all() and torch.isfinite(lse_t).all(),
              "flash_band_fwd gave a NaN or an infinity")
        check((lse_t[:, :, ~live] <= -1e29).all(),
              "flash_band_fwd: a row with no live key kept weight")
        err_o, err32, tc, fwd_text = hold_forward(
            fa, "flash_band_fwd", out, lse_t, (q, k, v), (off, window),
            (True, window, off), rows=live)
        check(tc == (dtype == torch.bfloat16 and d in (64, 128)),
              f"flash_band_fwd took the wrong route at {(b, s, h, d, dtype)}")
        route = "flash_band_fwd_wgmma" if tc else "flash_band_fwd"
        check(after[route] == before[route] + 1,
              f"flash_band_fwd was not counted on its route at "
              f"{(b, s, h, d)}")
        worst32["flash_band_fwd"] = max(worst32["flash_band_fwd"], err32)
        args = (q, k, v, do, lse, delta)
        grads = []
        for name, got in (("flash_band_dq", (dq,)),
                          ("flash_band_dkv", (dk, dv))):
            err, err32, tc, text = hold_backward(
                fa, name, got, args, (off, window), (True, window, off))
            check(tc == (dtype == torch.bfloat16 and d in (64, 128)),
                  f"{name} took the wrong route at {(b, s, h, d, dtype)}")
            grads.append(text)
            worst[name] = max(worst[name], err)
            worst32[name] = max(worst32[name], err32)
        print(f"kernel band B={b} S={s} H={h} H_kv={h_kv} D={d} "
              f"{str(dtype)[6:]} off={off} window={window} "
              f"({int((~live).sum())} rows with no key) "
              f"[{'tensor cores' if tc else 'loop'}]: {fwd_text}; f32 "
              f"gradients " + "; ".join(grads), flush=True)
        worst["flash_band_fwd"] = max(worst["flash_band_fwd"], err_o)
        if (b, s, h, h_kv, d, dtype) == path:
            # timed on dense lse and delta, as the ring passes them
            timed[off] = band_timings(
                fa, (q, k, v, do, lse.contiguous(), delta.contiguous()), off,
                window, band_work(*path, off, window))
        del q, k, v, do, lse, delta, out, dq, dk, dv, args
        torch.cuda.empty_cache()

    entries = []
    mix = SP_BAND_OFFSETS
    for name, replaces in zip(names, (242, 283, 317)):
        def mean(key):
            return sum(timed[o][name][key] for o in mix) / len(mix)
        by = {timed[o][name]["bound_by"] for o in mix}
        entries.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/" + (
                "flash_fwd.cu" if name == "flash_band_fwd" else
                "flash_bwd.cu"),
            "replaces": f"horovod_tpu/ops/flash_attention.py:{replaces}",
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": by.pop() if len(by) == 1 else "operations",
            "library_ms": mean("library_ms"),
            "library": timed[mix[0]][name]["library"],
            "by_offset": {o: timed[o][name] for o in sorted(timed)},
            "shape": "B 2, S 2048, H 16, H_kv 4, D 128, bf16, window 4096; "
                     "times are means per launch over the path's offsets "
                     f"{mix}",
            "max_abs_err": worst[name],
            "max_abs_err_f32_plain": worst32[name],
        })
    return entries


def band_timings(fa, args, off, window, work):
    """{kernel: ms, plain_ms, bound_ms, bound_by, library_ms, library} at
    one offset of the path's shape. The library call is SDPA with the
    tile's band as an explicit boolean ``attn_mask`` (the flash backend
    takes no arbitrary mask), k and v expanded to the query heads before
    the timed calls; its backward is forward + backward less forward, dq,
    dk and dv together."""
    q, k, v, do, lse, delta = args
    s = q.shape[1]
    ms = {
        "flash_band_fwd": time_ms(lambda: fa.flash_band_fwd(q, k, v, off,
                                                            window), 20),
        "flash_band_dq": time_ms(lambda: fa.flash_band_dq(*args, off,
                                                          window), 10),
        "flash_band_dkv": time_ms(lambda: fa.flash_band_dkv(*args, off,
                                                            window), 10),
    }
    bf16 = torch.bfloat16  # the tensor-core route's plain versions
    plain = {
        "flash_band_fwd": time_ms(lambda: fa.flash_band_fwd_reference(
            q, k, v, off, window, operand_dtype=bf16), 3),
        "flash_band_dq": time_ms(lambda: fa.flash_band_dq_reference(
            *args, off, window, operand_dtype=bf16), 3),
        "flash_band_dkv": time_ms(lambda: fa.flash_band_dkv_reference(
            *args, off, window, operand_dtype=bf16), 3),
    }
    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(group, dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    g = do.transpose(1, 2)
    pos = torch.arange(s, device=q.device)
    dist = off + pos[:, None] - pos[None, :]
    mask = (dist >= 0) & (dist < window)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd():
        return sdpa(qt, kt, vt, attn_mask=mask)

    def both():
        return torch.autograd.grad(fwd(), (qt, kt, vt), g)

    lib_fwd, lib_both = time_ms(fwd, 10), time_ms(both, 10)
    kernel_fwd, kernel_both = top_kernel(fwd), top_kernel(both)
    library = {
        "flash_band_fwd": (lib_fwd, f"scaled_dot_product_attention with a "
                                    f"band attn_mask (kernel {kernel_fwd})"),
        "flash_band_dq": (lib_both - lib_fwd,
                          f"scaled_dot_product_attention backward with a "
                          f"band attn_mask, dq, dk and dv together (kernel "
                          f"{kernel_both})"),
    }
    library["flash_band_dkv"] = library["flash_band_dq"]
    out = {}
    for name in ms:
        nbytes, flops = work[name]
        bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
        out[name] = {"ms": ms[name], "plain_ms": plain[name],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library[name][0],
                     "library": library[name][1]}
        print(f"kernel {name} timing at off {off}: {ms[name]:.4f} ms, plain "
              f"{plain[name]:.4f} ms, SDPA {library[name][0]:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops / ms[name] / 1e9:.1f} "
              f"TFLOP/s)", flush=True)
    print(f"kernel band SDPA at off {off}: forward {kernel_fwd}; backward "
          f"{kernel_both}", flush=True)
    return out


def phase_sp_parity(tfm, RingAxis, card):
    """One step's loss and gradients through the sp-4 ring against the
    model without SP at the same window, full width on one batch of
    2 x 8192, with each run's peak memory; and a small f32 model's ring
    (flash tiles, band tiles with rows that see no key, a pruned ring)
    against dense attention."""
    rng = np.random.default_rng(4)
    small = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
                 n_layers=2, d_ff=256, max_seq=256, positional="rope",
                 attention_window=100)
    runs = (("full width 2 x 8192", SP_MODEL, SP_BATCH, SP_SEQ,
             torch.bfloat16, (("ring", "flash", True), ("flash", "flash",
                                                        False))),
            ("small f32", small, 2, 256, torch.float32,
             (("ring", "flash", True), ("dense", "dense", False))))
    for label, kw, batch, seq, dtype, pair in runs:
        tokens = torch.from_numpy(rng.integers(0, kw["vocab_size"],
                                               (batch, seq))).to(card)
        targets = torch.roll(tokens, -1, dims=1)
        params, loss, grads, peak = None, {}, {}, {}
        for name, impl, ring in pair:
            cfg = tfm.TransformerConfig(dtype=dtype, attention_impl=impl,
                                        loss_chunk=min(LOSS_CHUNK, seq), **kw)
            if params is None:
                params = tfm.init_params(cfg, torch.Generator().manual_seed(5),
                                         card)
            axes = tfm.ShardAxes(sp=RingAxis.local(SP_RING)) if ring else None
            for t in _leaves(params):
                t.grad = None
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss[name], g = _loss_and_grads(tfm, params, cfg, tokens, targets,
                                            axes)
            peak[name] = torch.cuda.max_memory_allocated() - base
            grads[name] = {k: v.float().clone() for k, v in g.items()}
            del g
        a, b = (p[0] for p in pair)
        dl = abs(loss[a] - loss[b])
        if dtype == torch.float32:
            err = max((grads[a][k] - grads[b][k]).abs().max().item()
                      for k in grads[b])
            print(f"parity sp {label}: loss {a} {loss[a]:.6f}, {b} "
                  f"{loss[b]:.6f}; max|dgrad|={err:.3g} (tol "
                  f"{SMALL_GRAD_ATOL:g})", flush=True)
            check(err <= SMALL_GRAD_ATOL and dl <= SMALL_GRAD_ATOL,
                  "small f32 model: ring and dense gradients disagree")
        else:
            rel = _rel_l2(grads[a], grads[b])
            worst = max(rel, key=rel.get)
            print(f"parity sp {label}: loss {a} {loss[a]:.6f}, {b} "
                  f"{loss[b]:.6f} (|d|={dl:.3g}, tol {TRAIN_LOSS_ATOL:g}); "
                  f"gradient relative L2 worst {rel[worst]:.4g} at {worst} "
                  f"(tol {TRAIN_GRAD_REL:g}), median "
                  f"{float(np.median(list(rel.values()))):.4g}; peak memory "
                  f"of loss and backward above what was allocated before "
                  f"(the new gradients included): {a} "
                  f"{peak[a] / 2 ** 30:.2f} GiB, {b} "
                  f"{peak[b] / 2 ** 30:.2f} GiB", flush=True)
            check(dl <= TRAIN_LOSS_ATOL, "ring and flash losses disagree")
            check(rel[worst] <= TRAIN_GRAD_REL,
                  "ring and flash gradients disagree")
        del params, grads
        torch.cuda.empty_cache()


def _flat_grads(params):
    out = {k: v.grad for k, v in params.items() if k != "layers"}
    for i, layer in enumerate(params["layers"]):
        out.update({f"layers.{i}.{k}": v.grad for k, v in layer.items()})
    return out


def _leaves(params):
    return [v for k, v in params.items() if k != "layers"] + \
        [v for layer in params["layers"] for v in layer.values()]


def _loss_and_grads(tfm, params, cfg, tokens, targets, axes=None):
    for t in _leaves(params):
        t.grad = None
        t.requires_grad_()
    loss = tfm.loss_fn(params, tokens, targets, cfg, axes)
    loss.backward()
    return loss.item(), _flat_grads(params)


def _rel_l2(a, b):
    """{leaf: |a - b| / |b|} over two gradient dicts."""
    return {k: ((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)).item()
            for k in b}


def phase_train_parity(tfm, card):
    """loss_fn and every parameter gradient through flash against dense:
    full width at B 1, S 1024 (bf16, with the f32 dense model as the
    yardstick of both), and a small f32 model."""
    rng = np.random.default_rng(2)
    small = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
                 n_layers=2, d_ff=256, max_seq=128, positional="rope")
    for label, kw, seq, dtype in (
            ("full width B 1 x 1024", FLAGSHIP, 1024, torch.bfloat16),
            ("small f32", small, 128, torch.float32)):
        tokens = torch.from_numpy(rng.integers(0, kw["vocab_size"],
                                               (1, seq))).to(card)
        targets = torch.roll(tokens, -1, dims=1)
        runs = [("flash", "flash", dtype), ("dense", "dense", dtype)]
        if dtype != torch.float32:
            runs.append(("f32 dense", "dense", torch.float32))
        params = None
        loss, grads = {}, {}
        for name, impl, dt in runs:
            cfg = tfm.TransformerConfig(dtype=dt, attention_impl=impl,
                                        loss_chunk=min(LOSS_CHUNK, seq), **kw)
            if params is None:
                params = tfm.init_params(cfg, torch.Generator().manual_seed(3),
                                         card)
            loss[name], g = _loss_and_grads(tfm, params, cfg, tokens,
                                            targets)
            grads[name] = {k: v.float().clone() for k, v in g.items()}
        dl = abs(loss["flash"] - loss["dense"])
        if dtype == torch.float32:
            err = max((grads["flash"][k] - grads["dense"][k]).abs().max()
                      .item() for k in grads["dense"])
            print(f"parity train {label}: loss {loss['flash']:.6f} vs "
                  f"{loss['dense']:.6f}; max|dgrad|={err:.3g} (tol "
                  f"{SMALL_GRAD_ATOL:g})", flush=True)
            check(err <= SMALL_GRAD_ATOL and dl <= SMALL_GRAD_ATOL,
                  "small f32 model: flash and dense gradients disagree")
            continue
        rel = {pair: _rel_l2(grads[pair[0]], grads[pair[1]])
               for pair in (("flash", "dense"), ("flash", "f32 dense"),
                            ("dense", "f32 dense"))}
        print(f"parity train {label}: loss flash {loss['flash']:.6f}, dense "
              f"{loss['dense']:.6f} (|d|={dl:.3g}, tol {TRAIN_LOSS_ATOL:g}), "
              f"f32 dense {loss['f32 dense']:.6f}", flush=True)
        for (a, b), r in rel.items():
            worst = max(r, key=r.get)
            print(f"parity train {label}: gradient relative L2 {a} vs {b}: "
                  f"worst {r[worst]:.4g} at {worst}, median "
                  f"{float(np.median(list(r.values()))):.4g}", flush=True)
        check(dl <= TRAIN_LOSS_ATOL, "flash and dense losses disagree")
        worst = {pair: max(r.values()) for pair, r in rel.items()}
        check(worst[("flash", "dense")] <= TRAIN_GRAD_REL,
              "flash and dense gradients disagree")
        check(worst[("flash", "f32 dense")]
              <= YARDSTICK_RATIO * worst[("dense", "f32 dense")],
              "flash gradients are farther from the f32 model than the "
              "dense path's")
        del params, grads
        torch.cuda.empty_cache()


def flops_per_token(params, cfg, seq):
    """bench_transformer.py's convention: 6 x the matrix-product
    parameters (q/k/v, o, the MLP, the LM head; not the embedding or the
    norms) plus 6 x n_layers x seq x d_model of causal attention (no
    discount for a window)."""
    p_mm = sum(v.numel() for layer in params["layers"]
               for k, v in layer.items()
               if k.startswith(("wq", "wk", "wo", "w1", "w2")))
    p_mm += params["lm_head"].numel()
    return 6 * p_mm + 6 * cfg.n_layers * seq * cfg.d_model


# Each kernel's launch counter in ops/flash_attention.py on the CUDA-core
# loop (the kernel's name) and on the tensor-core route (<name>_wgmma).
PREFIXES = {"flash_fwd": "", "flash_band_fwd": "band_", "flash_bwd_dq": "dq_",
            "flash_bwd_dkv": "dkv_", "flash_band_dq": "band_dq_",
            "flash_band_dkv": "band_dkv_"}
WGMMA = {n: n + "_wgmma" for n in PREFIXES}
COUNTERS = {**{n: f"{p}launches" for n, p in PREFIXES.items()},
            **{WGMMA[n]: f"{p}wgmma_launches" for n, p in PREFIXES.items()}}


def read_launches(fa):
    """{kernel route (the loop as the kernel's name, the tensor cores as
    <name>_wgmma): launches}."""
    return {n: getattr(fa, c) for n, c in COUNTERS.items()}


def zero_launches(fa):
    for c in COUNTERS.values():
        setattr(fa, c, 0)


def phase_train(hvd, fa, tfm, card, where, ring=None):
    """Main path 2 (``ring`` None: batch 4 x 4096) or 3 (``ring`` a
    RingAxis: the SP model at batch 2 x 8192): init ->
    broadcast_parameters -> DistributedOptimizer -> loss_fn, warm-up plus
    timed steps on one batch, counts zeroed around it. Returns {kernel:
    launches}."""
    dump = os.path.join(tempfile.mkdtemp(), "profiler.txt")
    os.environ["HOROVOD_PROFILER_PATH"] = dump
    os.environ.pop("HOROVOD_PROFILER_DISABLE", None)
    hvd.init(device=card)
    check(hvd.size() == 1 and hvd.runtime.device().type == card.type,
          f"init: {hvd.size()} ranks on {hvd.runtime.device()}")
    if ring is None:
        label, batch, seq, model, axes = ("train", TRAIN_BATCH, TRAIN_SEQ,
                                          FLAGSHIP, None)
    else:
        label, batch, seq, model = "sp train", SP_BATCH, SP_SEQ, SP_MODEL
        axes = tfm.ShardAxes(sp=ring)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **model)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card, axes=axes)
    hvd.broadcast_parameters(lm.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), **ADAMW),
        named_parameters=lm.named_parameters())
    n_buckets = len(opt.exchange_buckets)
    grad_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (batch, seq))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)
    stats = hvd.runtime.live_state().stats
    calls0 = stats.counter("allreduce")
    time0 = stats.total_time_us("allreduce")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    steps = WARMUP_STEPS + TIMED_STEPS
    zero_launches(fa)
    events, losses = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.zero_grad(set_to_none=True)
        loss = lm.loss(tokens, targets)
        loss.backward()
        opt.step()
        end.record()
        events.append((start, end))
        losses.append(loss.detach())
    torch.cuda.synchronize()
    launches = read_launches(fa)

    losses = [x.item() for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in events[WARMUP_STEPS:]]
    peak = torch.cuda.max_memory_allocated()
    calls = stats.counter("allreduce") - calls0
    exchange_ms = (stats.total_time_us("allreduce") - time0) / 1e3 / steps
    hist = stats.histogram("allreduce")
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    # a step's launches per layer: one of each static kernel per local
    # shard (the diagonal tiles), one of each band kernel per live
    # visiting tile; every launch on the tensor-core route, none
    # on the loop
    shards = 1 if ring is None else len(ring.shards)
    bands = 0 if ring is None else len(SP_BAND_OFFSETS)
    for name, n in launches.items():
        per_layer = bands if name.startswith("flash_band") else shards
        if name in WGMMA:
            per_layer = 0
        check(n == steps * cfg.n_layers * per_layer,
              f"{name} launched {n} times in {steps} steps of "
              f"{cfg.n_layers} layers, {per_layer} a layer expected")
    check(calls == steps * n_buckets,
          f"{calls} all-reduces in {steps} steps of {n_buckets} buckets")
    check(hist.get(grad_bytes, (0, 0))[0] == steps,
          f"all-reduce sizes {hist} do not cover {grad_bytes} gradient "
          f"bytes once a step")
    median = float(np.median(step_ms))
    tok_s = batch * seq / (median / 1e3)
    fpt = flops_per_token(lm.params, cfg, seq)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"{label} losses: {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    print(f"{label} {batch} x {seq} tokens"
          f"{'' if ring is None else f' over {ring}, window {SP_WINDOW}'}, "
          f"{n_params / 1e6:.1f} M "
          f"parameters [{where}]: step {median:.1f} ms (median of "
          f"{TIMED_STEPS}; {' '.join(f'{t:.1f}' for t in step_ms)}); "
          f"{tok_s:.1f} tokens/s; {fpt / 1e9:.3f} GFLOP/token; MFU "
          f"{fpt * tok_s / PEAK_FLOPS[torch.bfloat16]:.4f} against 989 "
          f"TFLOP/s bf16 (the port's products run in f32); exchange "
          f"{exchange_ms:.3f} ms/step over {calls // steps} bucket(s) of "
          f"{grad_bytes / 1e9:.3f} GB; peak memory "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    print(f"{label} launches in {steps} steps: {launches}", flush=True)
    del opt, lm
    gc.collect()
    hvd.shutdown()
    with open(dump) as f:
        counter = next((line for line in f if
                        line.startswith("Counter allreduce,")), None)
    check(counter is not None and int(counter.split(",")[1]) >= calls,
          f"profiler dump {dump}: {counter!r}")
    print(f"{label} shutdown: profiler dump {counter.strip()}", flush=True)
    torch.cuda.empty_cache()
    return launches


COMPILED_STEPS, REPLAYS = 3, 4


def phase_compiled_train(hvd, fa, tfm, card, where):
    """Main path 6: the flagship at batch 4 x 4096 through
    ``compiled_train_step`` over ``DistributedOptimizer(AdamW(...,
    capturable=True))``, under HOROVOD_PROFILER_JIT_CALLBACKS=1. First
    COMPILED_STEPS eager steps of the same optimizer from the same init
    (the last ones timed); then COMPILED_STEPS compiled steps (the
    first runs eagerly and captures the graph, the rest replay it), whose
    parameters must equal the eager run's bitwise, with 1 cache miss, the
    rest hits and no fallback; then REPLAYS timed replays, each with 8
    launches of each static kernel on the tensor-core route and the
    eager path's one all-reduce a bucket. Returns {kernel: launches} of
    the compiled steps."""
    os.environ["HOROVOD_PROFILER_JIT_CALLBACKS"] = "1"
    hvd.init(device=card)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (TRAIN_BATCH, TRAIN_SEQ))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)

    def build():
        lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                               device=card)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
            named_parameters=lm.named_parameters())
        return lm, opt

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        loss = fn()
        host = time.perf_counter() - t0
        end.record()
        return loss, (start, end), host

    lm, opt = build()
    eager = []
    for _ in range(COMPILED_STEPS):
        def step():
            opt.zero_grad(set_to_none=True)
            loss = lm.loss(tokens, targets)
            loss.backward()
            opt.step()
            return loss.detach()
        eager.append(timed(step))
    torch.cuda.synchronize()
    want = {n: p.detach().cpu() for n, p in lm.named_parameters()}
    eager_losses = [x[0].item() for x in eager]
    eager_ms = [a.elapsed_time(b) for _, (a, b), _ in eager[1:]]
    del lm, opt, eager
    gc.collect()
    torch.cuda.empty_cache()

    lm, opt = build()
    n_buckets = len(opt.exchange_buckets)
    step = hvd.compiled_train_step(lm.loss, opt)
    stats = hvd.runtime.live_state().stats
    zero_launches(fa)
    runs = [timed(lambda: step(tokens, targets))
            for _ in range(COMPILED_STEPS)]
    torch.cuda.synchronize()
    losses = [x[0].item() for x in runs]
    got = {n: p.detach().cpu() for n, p in lm.named_parameters()}
    deltas = {n: float((got[n] - want[n]).abs().max()) for n in want}
    differ = {n: deltas[n] for n in want if not torch.equal(got[n], want[n])}
    del got, want
    prog = next(iter(hvd.runtime.live_state().programs._programs.values()))
    jit0 = stats.counter("allreduce_jit")
    replay_launches0 = read_launches(fa)
    replays = [timed(lambda: step(tokens, targets)) for _ in range(REPLAYS)]
    torch.cuda.synchronize()
    launches = read_launches(fa)
    per_replay = {k: (launches[k] - replay_launches0[k]) / REPLAYS
                  for k in launches}
    jit_calls = stats.counter("allreduce_jit") - jit0
    replay_ms = [a.elapsed_time(b) for _, (a, b), _ in replays]
    host_ms = [h * 1e3 for _, _, h in replays]
    print(f"compiled train losses: {' '.join(f'{x:.4f}' for x in losses)} "
          f"(eager {' '.join(f'{x:.4f}' for x in eager_losses)})", flush=True)
    print(f"compiled train vs eager after {COMPILED_STEPS} steps: "
          f"{len(differ)} of {len(deltas)} parameters differ, max|d| "
          f"{max(deltas.values()):.3g}"
          + (f" (worst {max(differ, key=differ.get)})" if differ else ""),
          flush=True)
    print(f"compiled train 4 x 4096 [{where}]: replay {np.median(replay_ms):.1f}"
          f" ms (median of {REPLAYS}; {' '.join(f'{t:.1f}' for t in replay_ms)})"
          f" against eager {np.median(eager_ms):.1f} ms (steps 2-"
          f"{COMPILED_STEPS} of the same optimizer); step() returns in "
          f"{np.median(host_ms):.3f} ms on the host; cache hits "
          f"{step.cache_hits} misses {step.cache_misses} fallbacks "
          f"{step.fallback_steps}; per replay {per_replay}; "
          f"{jit_calls} allreduce_jit records in {REPLAYS} replays",
          flush=True)
    check(not differ, f"compiled parameters differ from eager: {differ}")
    check(losses == eager_losses, f"losses {losses} vs eager {eager_losses}")
    check((step.cache_misses, step.fallback_steps) == (1, 0)
          and step.cache_hits == COMPILED_STEPS + REPLAYS - 1,
          f"cache {step.cache_hits}/{step.cache_misses}, fallbacks "
          f"{step.fallback_steps}")
    for name, n in per_replay.items():
        want_n = cfg.n_layers if name in ("flash_fwd_wgmma",
                                          "flash_bwd_dq_wgmma",
                                          "flash_bwd_dkv_wgmma") else 0
        check(n == want_n, f"{name}: {n} launches a replay, {want_n} "
                           "expected")
    check(len(prog.collectives) == n_buckets and jit_calls
          == REPLAYS * n_buckets,
          f"all-reduces a replay: {prog.collectives}, {jit_calls} records "
          f"in {REPLAYS} replays of {n_buckets} bucket(s)")
    del step, prog, opt, lm
    gc.collect()
    hvd.shutdown()
    os.environ.pop("HOROVOD_PROFILER_JIT_CALLBACKS")
    torch.cuda.empty_cache()
    return launches


# bench.py's ResNet-50: 224 x 224, bf16, the per-chip batch its sweep
# picks on this card (256), SGD(0.01); one warm-up and RESNET_STEPS timed
# steps on one batch (numpy seed 2).
RESNET_BATCH, RESNET_SIZE, RESNET_STEPS = 256, 224, 5
# bench.py's MFU constant: 3 x 4.09 G multiply-adds per image (x2 for
# FLOPs), over the bf16 peak.
RESNET_TRAIN_MACS_PER_IMAGE = 3 * 4.09e9
# The f32 forward at batch 2 (train mode) on the card against the same
# weights on the CPU: both exact f32 (TF32 off for cuDNN and matmuls), in
# other summation orders through 53 convolutions and batch norms; held
# to 1e-3 of the largest |logit|.
RESNET_F32_REL = 1e-3
# Running statistics after one bf16 train step against Flax's rule
# computed here in f64 from each batch norm's input: the port sums in
# f32 over up to 3.2 M values a channel.
BN_STATS_ATOL, BN_STATS_RTOL = 1e-5, 1e-4
# Batch norms whose statistics are checked: the stem's, a zero-scale
# third one, the one after a stride-2 3x3 (SAME pads it (0, 1)), a
# projection's and the last.
BN_CHECKED = ("bn_init", "BottleneckBlock_0.BatchNorm_2",
              "BottleneckBlock_3.BatchNorm_1", "BottleneckBlock_3.proj_bn",
              "BottleneckBlock_15.BatchNorm_2")


def phase_resnet(hvd, card, where):
    """ResNet-50 as bench.py trains it: the f32 forward against the CPU,
    then the bf16 channels_last model at batch RESNET_BATCH through
    init -> broadcast_parameters -> DistributedOptimizer(SGD(0.01)): the
    batch-norm statistics after one step against Flax's rule, a falling
    loss over RESNET_STEPS more, the bucket all-reduces counted, img/s and
    MFU printed. The convolutions run on cuDNN: the reference has no hand
    kernel for them, so this path launches none of the kernels above."""
    from horovod_tpu_torch import hardware
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.models._flax_ops import BatchNorm

    # The f32 forward, card against CPU, on the same weights; the batch
    # norms' scales and biases drawn so that no block passes through.
    gen = torch.Generator().manual_seed(0)
    cpu = ResNet50(dtype=torch.float32, generator=gen, device="cpu")
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, BatchNorm):
                m.scale.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
    on_card = ResNet50(dtype=torch.float32, device=card)
    on_card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 3, RESNET_SIZE, RESNET_SIZE, generator=gen)
    with torch.no_grad():
        want = cpu(x)
        got = on_card(x.to(card)).cpu()
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    print(f"resnet f32 forward B 2 x {RESNET_SIZE}^2, card against CPU: "
          f"max|d| {err:.3g} of max|logit| {top:.3g} (tol "
          f"{RESNET_F32_REL:g} of it); TF32 for cuDNN "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    check(err <= RESNET_F32_REL * top, "f32 ResNet-50 card != CPU")
    del cpu, on_card

    hvd.init(device=card)
    model = ResNet50(generator=torch.Generator().manual_seed(0),
                     device=card).to(memory_format=torch.channels_last)
    model.train()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())
    n_buckets = len(opt.exchange_buckets)
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE), dtype=np.float32)).to(
        card, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    labels = torch.from_numpy(rng.integers(0, 1000, RESNET_BATCH)).to(card)
    stats = hvd.runtime.live_state().stats
    calls0 = stats.counter("allreduce")
    bns = dict(model.named_modules())
    before = {n: (bns[n].mean.clone(), bns[n].var.clone())
              for n in BN_CHECKED}
    seen = {}
    hooks = [bns[n].register_forward_pre_hook(
        lambda mod, inp, n=n: seen.__setitem__(n, inp[0].detach()))
        for n in BN_CHECKED]

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step()]
    for h in hooks:
        h.remove()
    worst = 0.0
    for n in BN_CHECKED:
        x = seen.pop(n).double()
        mean = x.mean(dim=(0, 2, 3))
        var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
        for got_s, old, batch in ((bns[n].mean, before[n][0], mean),
                                  (bns[n].var, before[n][1], var)):
            want_s = 0.9 * old.double() + 0.1 * batch
            err = (got_s.double() - want_s).abs()
            check(bool((err <= BN_STATS_ATOL
                        + BN_STATS_RTOL * want_s.abs()).all()),
                  f"{n}: running statistics off Flax's rule by "
                  f"{err.max().item():.3g}")
            worst = max(worst, (err / (want_s.abs() + 1e-3)).max().item())
        del x
    print(f"resnet batch-norm statistics after one step, {len(BN_CHECKED)} "
          f"layers against Flax's rule in f64: worst relative "
          f"{worst:.3g} (tol {BN_STATS_ATOL:g} + {BN_STATS_RTOL:g} "
          f"relative)", flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RESNET_STEPS):
        losses.append(step())
    end.record()
    torch.cuda.synchronize()
    losses = [x.item() for x in losses]
    ms = start.elapsed_time(end) / RESNET_STEPS
    calls = stats.counter("allreduce") - calls0
    check(all(np.isfinite(losses)), f"resnet losses {losses}")
    check(losses[-1] < losses[0], f"resnet loss did not fall: {losses}")
    check(calls == (1 + RESNET_STEPS) * n_buckets,
          f"{calls} all-reduces in {1 + RESNET_STEPS} steps of "
          f"{n_buckets} buckets")
    img_s = RESNET_BATCH / (ms / 1e3)
    peak = hardware.peak_flops_per_chip(None, card)
    mfu = RESNET_TRAIN_MACS_PER_IMAGE * img_s / peak if peak else None
    print(f"resnet losses: {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    print(f"resnet50 train B {RESNET_BATCH} x {RESNET_SIZE}^2 bf16 "
          f"channels_last [{where}]: step {ms:.1f} ms (mean of "
          f"{RESNET_STEPS}), {img_s:.1f} img/s, MFU "
          f"{'n/a' if mfu is None else f'{mfu:.4f}'} (bench.py's constant: "
          f"multiply-adds, x2 for FLOPs) against {peak / 1e12:.0f} TFLOP/s "
          f"bf16; {calls // (1 + RESNET_STEPS)} all-reduce(s) a step; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    del opt, model, images
    gc.collect()
    hvd.shutdown()
    torch.cuda.empty_cache()


def _bench_line(args, env, timeout):
    """Run a bench module; its one JSON line (the last of its output)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    check(out.returncode == 0,
          f"{' '.join(args)} exited {out.returncode}: {out.stderr[-3000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"bench {' '.join(args)} in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(line)[:1500]}", flush=True)
    return line


def phase_bench(where):
    """Both bench modules as a user runs them: bench.resnet in its
    HOROVOD_BENCH_SMOKE shrink (with the flagship's row at 1 iteration),
    bench.transformer at --iters 2. Each line must name its metric, with
    a positive value and a numeric MFU on this card."""
    env = {**os.environ, "HOROVOD_BENCH_SMOKE": "1"}
    res = _bench_line(["horovod_tpu_torch.bench.resnet"], env, 600)
    env.pop("HOROVOD_BENCH_SMOKE")
    tfm = _bench_line(["horovod_tpu_torch.bench.transformer", "--iters",
                       "2"], env, 600)
    for line, metric in ((res, "resnet50_img_sec_per_chip"),
                         (res["transformer"],
                          "transformer_tokens_per_sec_per_chip"),
                         (tfm, "transformer_tokens_per_sec_per_chip")):
        check(line.get("metric") == metric and line["value"] > 0
              and isinstance(line["mfu_pct"], (int, float)),
              f"bench line {line}")
    check(tfm["attention"] == "flash", f"bench attention {tfm['attention']}")
    compiled, srv = res["compiled_step"], res["serve"]
    check(compiled["fallback_steps"] == 0
          and compiled["step_program_cache_hit_rate"] == 1.0
          and compiled["img_sec_per_chip"] > 0,
          f"bench compiled_step row {compiled}")
    check(srv["decode_cache_hit_rate"] >= 0.9 and srv["fallback_steps"] == 0
          and srv["tokens_per_sec"] > 0, f"bench serve row {srv}")
    print(f"bench [{where}]: resnet smoke {res['value']} img/s (MFU "
          f"{res['mfu_pct']}%, multiply-adds), compiled "
          f"{compiled['img_sec_per_chip']} img/s (python overhead "
          f"{compiled['python_overhead_ms']} ms a step); serve row "
          f"{srv['tokens_per_sec']} tokens/s, token latency p50/p99 "
          f"{srv['token_latency_p50_ms']}/{srv['token_latency_p99_ms']} ms; "
          f"transformer {tfm['value']} tokens/s (MFU {tfm['mfu_pct']}%)",
          flush=True)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    where = card_line()
    print(where, flush=True)
    card = torch.device("cuda")

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, serve
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    from horovod_tpu_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs) or 'up to date'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        kernel_usage(fa, _build, name, log)

    gen = torch.Generator(device=card).manual_seed(0)
    entry = phase_kernels(fa, card, gen)
    bwd_entries, train_fwd = phase_backward_kernels(fa, card, gen)
    entry["train_shape"] = train_fwd
    band_entries = phase_band_kernels(fa, card, gen)

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **FLAGSHIP)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"model: {n_params / 1e6:.1f} M parameters (f32), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}", flush=True)
    phase_parity(tfm, ServeEngine, lm.params, card)
    phase_train_parity(tfm, card)

    serve_launches = phase_serve(fa, serve, metrics, lm, card, where)
    t0 = time.perf_counter()
    compiled_serve_launches = phase_compiled_serve(fa, serve, metrics, tfm,
                                                   lm, card, where)
    print(f"compiled serve phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    del lm
    torch.cuda.empty_cache()
    train_launches = phase_train(hvd, fa, tfm, card, where)
    t0 = time.perf_counter()
    compiled_train_launches = phase_compiled_train(hvd, fa, tfm, card, where)
    print(f"compiled train phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_sp_parity(tfm, RingAxis, card)
    sp_launches = phase_train(hvd, fa, tfm, card, where,
                              RingAxis.local(SP_RING))
    t0 = time.perf_counter()
    phase_resnet(hvd, card, where)
    phase_bench(where)
    print(f"resnet and bench phases: {time.perf_counter() - t0:.1f} s",
          flush=True)

    entries = [entry, bwd_entries["flash_bwd_dq"],
               bwd_entries["flash_bwd_dkv"], *band_entries]
    paths = {"serve": serve_launches, "train": train_launches,
             "sp_train": sp_launches,
             "compiled_serve": compiled_serve_launches,
             "compiled_train": compiled_train_launches}
    for e in entries:
        # a kernel's launches are its tensor-core route's: the main paths
        # launch its loop never (checked in phase_serve and phase_train)
        counted = WGMMA[e["name"]]
        by_path = {p: n[counted] for p, n in paths.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        e["route_on_main_paths"] = "tensor cores (wgmma)"
        check(e["launches"] > 0, f"{e['name']} never ran on a main path")
    print(f"chip_smoke: wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
