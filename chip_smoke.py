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
   shapes. Both at a TP rank's heads too (H 8 / H_kv 2: the prefill
   B 8 x 512 and the training B 1 x 4096, whose dO has the batch stride
   1 that autograd gives it there). Every kernel, forward and backward, takes the tensor-core
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

Mixture-of-Experts has three phases of its own, after the compiled
train phase, on flagship-moe (``MOE_MODEL``: the flagship with an MoE
FFN in layers 1, 3, 5 and 7, 8 experts, top-2, capacity factor 1.25;
1426 M parameters, drawn once on the host from seed 0):

- moe parity: the MoE layer at full width (d 2048, ff 8192, 4 x 4096
  tokens, f32, a router skewed so that capacity drops happen) in index
  form against its dense plain version on the card (routing tables
  equal to the dense tensors, aux and counts equal, outputs within
  MOE_LAYER_REL), and flagship-moe cut to 2 layers (dense attention,
  full capacity) on the card against the CPU (router probabilities
  within MOE_PROB_ATOL, logits within LOGITS_ATOL wherever both sides
  pick the same experts);
- moe train (main path 7): flagship-moe at 4 x 4096 as the compiled
  train phase runs the flagship (3 eager steps, 3 compiled steps and 4
  replays, bitwise against eager; the expert stacks' gradients on the
  expert keys), with step time, tokens/s and peak memory; then the
  ``hvd_moe_*`` counters of one evaluation: dropped = t * k * MoE layers
  - routed;
- moe serve (main path 8): the serving workload on flagship-moe through
  the eager and the graph engine (tokens identical, steady decode hit
  rate 1.0, no fallback), MoE layers at full capacity: nothing dropped.

The bench phase also runs ``bench.transformer --moe --expert-parallel
1`` and checks the ``moe`` rows, and checks that bench.resnet's
``zero_profile`` row is filled (at one rank: no DCN stage, so
``dcn_bytes_saved_frac`` is None and the stripes are the whole row).

The ZeRO ladder has a phase of its own, after the compiled train phase:

- zero train (main path 9): the flagship at 4 x 4096 through
  ``DistributedOptimizer(AdamW(..., capturable=True), zero_stage=s)``,
  s = 1, 2, 3, as the compiled train phase runs it (3 eager steps, 3
  compiled steps and 4 replays): parameters after 3 steps bitwise equal
  to the eager run's and to stage 0's compiled run (one rank: the
  scatter and gather are copies, the division by 1), zero3's
  ``unshard_params(shard_params(p)) == p``, per replay 8 launches of
  each static kernel on the tensor-core route and one reduce-scatter
  and one all-gather record a chunk, 1 cache miss and no fallback;
  step time, tokens/s, peak memory and the ``hvd_zero_stripe_bytes``
  gauges beside stage 0's. The three stages share one session: a
  dropped step leaves the program cache, so each peak lies within 0.5
  GiB of the one the stage reaches in a session of its own. The staged
  exchange needs two ranks and NCCL refuses two on one card: it is
  checked on the CPU only, and the phase says so.

Tensor parallelism has a phase of its own, after the zero train phase:
two processes on this card (``chip_smoke.py --tp-rank R PORT OUT``),
one model group joined by gloo, which moves card tensors through the
host (NCCL refuses two ranks on one card); each checks first that gloo
carries card tensors, then ``hvd.init()`` keeps that group and builds
the 3-D mesh. The flagship at full width, each rank H 8 / H_kv 2:

- tp serve (main path 10): the 8 requests through ``ServeEngine(mesh,
  tp_axis)`` in lockstep, teacher-forced on the unsharded engine's
  greedy streams (logits within LOGITS_ATOL; the argmax equal wherever
  the unsharded top-2 gap exceeds TP_NEAR_TIE) and free running (each
  stream equal to the unsharded one up to such a near-tie); each rank's
  KV pool holds H_kv 2; 16 ``flash_fwd`` launches a rank. Off the
  counted path, the same 8 requests in f32 activations: every TP token
  identical to the unsharded engine's;
- tp train (main path 11): B 1 x 4096 through the sharded trunk and
  ``DistributedOptimizer(AdamW, model_keys=...)``: the loss within
  TRAIN_LOSS_ATOL of the unsharded model's, every gathered gradient
  within TRAIN_GRAD_REL (a model leaf's divided by the group's size:
  the reference's psum transposes to a psum), the loss falling over 3
  AdamW steps; 8 launches of each static kernel a step.

Its times are gloo's through the host with two ranks on one card, not
a TP speed figure, and the phase prints them so.

The tp train phase also runs an f32-activation leg of the same step,
off the counted path: the gathered gradients against the unsharded f32
model's within TP_F32_GRAD_REL, its worst and median relative L2
printed (how far the bf16 gap is the order of the sums).

Ulysses, the SP step in graphs and the pipeline (PR 11), after the SP
train phase:

- kernels: ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` at
  Ulysses' shard shape (B 2, S 8192, H 4 / H_kv 1, D 128, bf16, causal,
  window 4096) on head-sliced views of the projections, against their
  plain versions (the backward's at B 1) and timed beside SDPA with the
  window as a mask (``ulysses_shape`` in the kernels line);
- ulysses parity: the sp parity phase also runs ``sp_impl="ulysses"``
  over a local axis of 4 against the unsharded flash model (bitwise
  equal or not, max|d| printed; within TRAIN_LOSS_ATOL and
  TRAIN_GRAD_REL) and a small f32 model's Ulysses against dense within
  SMALL_GRAD_ATOL;
- ulysses train (main path 12): that model trained as the SP train
  phase trains the ring, 32 launches of each static kernel and no band
  kernel a step, all on the tensor cores, its step time, tokens/s and
  peak beside the ring's;
- compiled sp (main path 13): the ring's and Ulysses' SP step through
  ``compiled_train_step`` with capturable AdamW as the compiled train
  phase runs the flagship (parameters after 3 steps bitwise equal to
  eager, 1 cache miss, no fallback; per replay the ring 32 static and
  40 band launches of each kernel, Ulysses 32 static);
- pipeline (main path 14): the flagship's 8 layers over a local pp
  axis of 4 at 4 x 4096 in 4 microbatches: GPipe, 1F1B and 1F1B at V 2
  against the unpipelined ``loss_fn`` (loss within TRAIN_LOSS_ATOL,
  gradients within TRAIN_GRAD_REL; a small f32 model within
  SMALL_GRAD_ATOL); then 3 AdamW steps each of the unpipelined model,
  GPipe and 1F1B, each loss falling, their step times (a local schedule
  on one card, not a PP speed) and peaks (1F1B's below GPipe's), and
  each pipelined step's launches exact: 32 ``flash_fwd`` (GPipe) or 64
  (1F1B: the backward phase's recompute) and 32 of each backward kernel.

The phase trace (diag/xla_trace.py) has a phase of its own, after the
compiled train phase:

- trace (main path 15): the flagship at 4 x 4096 with capturable AdamW
  under ``DistributedOptimizer``, random weights from seed 0:
  ``hvd.trace_steps(4)`` over the ``compiled_train_step`` replay (the
  program re-captures once for its phase map), over the eager step
  ticked by ``TelemetryCallback`` (its regions under the same phase
  ranges), and over one graph serve round of the 8 requests. Each
  prints its device ms a step by phase, ``other``, its device time and
  ``exchange_hidden_frac``; the step also prints ``flops_per_step``
  (FlopCounterMode and the flash kernels' own counts), MFU and the idle
  tracer's and flight recorder's cost over a loop of 3 eager steps. Its
  gates: each window's phases plus ``other`` equal the device time of
  its kernels, copies and sets summed from the capture files within
  TRACE_SUM_REL; a step's ``other`` stays under TRACE_OTHER_MAX of it,
  replayed or eager; each replayed phase above TRACE_PHASE_FLOOR of the
  step lies within TRACE_PHASE_REL of the eager step's; the serve round
  keeps TRACE_SERVE_MIN of its device time in prefill and decode;
  ``flash_fwd_wgmma_kernel`` lands in forward alone and the two
  backward kernels in backward alone; both idle costs stay under
  TRACE_OVERHEAD_MAX of the loop; and the traced replays' launches by
  route equal an untraced replay's, and the parameters after the 7
  compiled steps the compiled train phase's after its 7 (the same seed
  and batch), bitwise.

The bench phase checks bench.resnet's trace rows too: the compiled
step's ``step_phase_breakdown``, ``wire_stage_ms``,
``exchange_hidden_frac``, ``overlap_ab`` and ``overlap_microbench``,
``flight_step_phase_breakdown`` and both overhead fractions filled,
``control_plane`` a skipped row naming item 10, and the MoE rows'
all-to-all keys None at ``--expert-parallel 1`` beside their phase
breakdown.

The kernels phases also run the CUDA-core loop at head dims 256 and 320
(the latter in 256-column pieces) against the plain versions and time
it (off every main path).

On every main path each kernel launch takes the tensor-core route: the
loop's counters stay at 0 there, and the route's counters are exact (8
``flash_fwd`` a prefill, replayed or not; 8 of each static kernel a
data-parallel step, replayed or not, traced or not, or a TP step; 32
static and 40 band of each a ring SP step, replayed or not; 32 static a
Ulysses step; the pipeline's above). A graph's replay counts the
launches its capture recorded; a TP path's launches are one rank's.

Each main path runs with the kernel launch counts zeroed just before it
and read just after. The first line is the card's name and power limit
as ``nvidia-smi`` gives them; the run's wall time is printed before the
last two lines, which are
``{"kernels": [...]}``, one entry per kernel, and the result,
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
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
# flagship-moe: the flagship with an MoE FFN in every other layer (as
# GShard and Switch place them, and tests/test_moe.py:201), 8 experts and
# top-2 routing (bench_transformer.py's --moe defaults, Mixtral's), the
# MoEConfig capacity factor 1.25; the expert stacks are the expert keys.
MOE_MODEL = dict(FLAGSHIP, moe_layers=(1, 3, 5, 7), moe_num_experts=8,
                 moe_top_k=2)
MOE_EXPERT_KEYS = ("moe.w1", "moe.w2")

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
# The MoE layer's index form against its dense plain version, f32, on
# the card: the same routing (tables equal the dense tensors exactly),
# the same expert rows, aux and counts; the dense combine's GEMM sums
# each token's two gate-weighted rows (and zeros) with fused multiply-
# adds in its own order, so an output may differ by a few f32 roundings
# of the largest magnitude: MOE_LAYER_REL of it.
MOE_LAYER_REL = 2.0 ** -20
# flagship-moe cut to 2 layers (layer 1 MoE) on the card against the CPU
# at B 1 x MOE_PARITY_SEQ: layer 1's router probabilities within
# MOE_PROB_ATOL, and the logits within LOGITS_ATOL at every position
# where both sides pick the same experts, which must be all but
# MOE_FLIPS of them. Routing is discrete: where two experts' router
# probabilities lie closer than the two sides' difference, each side may
# pick another (both answers right), and that position's output differs
# by a whole expert's. The sides differ in f32 summation order, which
# flips a bf16 rounding now and then; a flipped rounding of a dominant
# softmax weight moves a whole head's output, so the router's input of
# that position moves on most of its elements. Both sides run dense
# attention (the same torch ops; the flash route rounds every P to bf16
# where the CPU's plain version does not) and the MoE layer at full
# capacity (nothing drops, so a position depends on its own routing only;
# in capacity mode a token's queue position, and so what drops, depends
# on every earlier token's routing). The flash route and the capacity
# mode are held by the kernel and layer checks above and by the CPU
# tests.
MOE_PARITY_SEQ, MOE_PROB_ATOL, MOE_FLIPS = 256, 2e-2, 256 // 50


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
        (8, PROMPT_LEN, 8, 2, 128, torch.bfloat16, True, None),  # TP prefill
        (1, TRAIN_SEQ, 8, 2, 128, torch.bfloat16, True, None),   # TP training
        (SP_BATCH, SP_SHARD, 16, 4, 128, torch.bfloat16, True,
         SP_WINDOW),                                    # SP diagonal tile
        (2, 1000, 16, 4, 128, torch.bfloat16, True, None),        # ragged
        (2, 1000, 16, 4, 128, torch.bfloat16, True, 256),         # window
        (2, 700, 8, 8, 64, torch.bfloat16, False, None),          # non-causal
        (2, 130, 4, 2, 8, torch.float32, True, None),             # small f32
        (2, 300, 4, 2, 256, torch.bfloat16, True, None),          # D 256
        (1, 200, 4, 1, 256, torch.float32, True, 50),     # D 256, window
        (2, 300, 4, 2, 320, torch.bfloat16, True, None),  # D 320, pieces
        (1, 200, 4, 1, 320, torch.float32, True, 50),     # D 320, window
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


def serve_both_engines(fa, serve, metrics, lm, card, where, label):
    """The serving workload through ``serve.Engine`` eagerly and through
    its graphs, each engine serving the 8 requests three times from this
    thread: a round that builds its programs (the graphs' warm-up and
    capture), a timed round (launch counts zeroed just before it and
    read just after), and a round under torch.profiler for the device
    time, whose ratio to the timed round's wall is the card's busy
    share. The graph engine's tokens must equal the eager one's, its
    timed round must hit its program cache on >= 0.9 of the decode
    steps with no fallback, and each prefill launches flash_fwd once a
    layer on the tensor cores. Prints each engine's prefill, decode
    step, token latency p50/p99, TTFT, tokens/s and busy share. Returns
    {mode: round}."""
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
        print(f"{label} [{mode}] {N_REQUESTS} x ({PROMPT_LEN} + "
              f"{NEW_TOKENS}) [{where}]: prefill {r['prefill_ms']:.2f} ms "
              f"({r['prefill_calls']} call); decode step "
              f"{r['decode_ms']:.2f} ms (mean of {r['decode_calls']}); "
              f"token latency p50 {np.percentile(r['tok'], 50):.2f} ms p99 "
              f"{np.percentile(r['tok'], 99):.2f} ms; ttft p50 "
              f"{np.percentile(r['ttft'], 50):.2f} ms; "
              f"{N_REQUESTS * NEW_TOKENS / r['wall_ms'] * 1e3:.1f} tokens/s; "
              f"device {r['device_ms']:.2f} ms of a {r['wall_ms']:.2f} ms "
              f"round, busy {r['busy']:.3f}", flush=True)
    print(f"{label}: tokens identical to eager; steady decode hit "
          f"rate {graphs['steady_hit_rate']:.3f}; decode step "
          f"{eager['decode_ms']:.2f} -> {graphs['decode_ms']:.2f} ms",
          flush=True)
    return res


def phase_compiled_serve(fa, serve, metrics, tfm, lm, card, where):
    """Main path 5: the serving workload through graph-replayed prefill
    and decode, beside the same engine run eagerly in this call
    (:func:`serve_both_engines`). Then ``generate``
    on the flagship: its graph-replayed greedy tokens against the eager
    ``decode_step``'s argmax, whose logits must lie within LOGITS_ATOL of
    a full forward over the same prefix. Returns {kernel: launches} of
    the graph engine's timed round and of ``generate``."""
    res = serve_both_engines(fa, serve, metrics, lm, card, where,
                             "compiled serve")
    graphs = res["graphs"]
    launches = graphs["launches"]
    vocab = lm.cfg.vocab_size

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
               shard=None, unit_batch_stride=False):
    """q, k, v, dO in ``dtype`` and the forward's lse and delta. With
    ``shard`` i, lse and delta are the strided views of shard i of a
    (B, H, SP_RING * S) pair, as a chunk of the ring's lse is. With
    ``unit_batch_stride`` (B 1), dO's batch stride is 1, as autograd
    hands it to the tensor-parallel step's backward."""
    q = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
    k = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
    v = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
    do = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
    if unit_batch_stride:
        check(b == 1, "a batch stride of 1 needs B 1")
        do = do.as_strided(do.shape, (1,) + do.stride()[1:])
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


# The TP training shape of the backward kernels: a rank's H 8 / H_kv 2
# at B 1, whose dO autograd hands over with a batch stride of 1.
TP_TRAIN_BWD = (1, TRAIN_SEQ, 8, 2, 128, torch.bfloat16, True, None)


def phase_backward_kernels(fa, card, gen):
    """flash_bwd_dq and flash_bwd_dkv against their plain versions at
    every listed shape; the kernels and SDPA's backward timed at the
    training shape, the plain versions at B 1. Returns the two entries
    of the kernels line (launches filled in by the main paths)."""
    cases = [  # (B, S, H, H_kv, D, dtype, causal, window)
        (1, TRAIN_SEQ, 16, 4, 128, torch.bfloat16, True, None),  # training
        (8, PROMPT_LEN, 8, 2, 128, torch.bfloat16, True, None),  # TP prefill
        TP_TRAIN_BWD,                      # TP training, dO batch stride 1
        # the SP path's diagonal tile, lse and delta strided as the ring's
        (SP_BATCH, SP_SHARD, 16, 4, 128, torch.bfloat16, True, SP_WINDOW),
        (1, 1000, 16, 4, 128, torch.bfloat16, True, None),       # ragged
        (1, 1000, 16, 4, 128, torch.bfloat16, True, 256),        # window
        (1, 700, 8, 8, 64, torch.bfloat16, False, None),         # non-causal
        (2, 130, 4, 2, 8, torch.float32, True, None),            # small f32
        (2, 300, 4, 2, 256, torch.bfloat16, True, None),         # D 256
        (1, 200, 4, 1, 256, torch.float32, True, 50),    # D 256, window
        (2, 300, 4, 2, 320, torch.bfloat16, True, None),  # D 320, pieces
        (1, 200, 4, 1, 320, torch.float32, True, 50),    # D 320, window
    ]
    names = ("flash_bwd_dq", "flash_bwd_dkv")
    worst = dict.fromkeys(names, 0.0)
    worst32 = dict.fromkeys(names, 0.0)
    plain_ms = {}
    for i, (b, s, h, h_kv, d, dtype, causal, window) in enumerate(cases):
        unit = cases[i] == TP_TRAIN_BWD
        args = bwd_inputs(fa, card, gen, b, s, h, h_kv, d, dtype, causal,
                          window, shard=1 if s == SP_SHARD else None,
                          unit_batch_stride=unit)
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
              f"{str(dtype)[6:]} causal={causal} window={window}"
              f"{' dO batch stride 1' if unit else ''} "
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
    for d in LOOP_WIDE_DIMS:
        wide = loop_wide_timings(fa, card, gen, d)
        train_fwd[f"loop_d{d}_ms"] = wide["flash_fwd"]
        for name in names:
            entries[name][f"loop_d{d}_ms"] = wide[name]
    return entries, train_fwd


# Head dims 256 and 320 run the CUDA-core loop only (off every main
# path; 320 in two 256-column pieces): their times at B 1 x S 4096,
# H 8 / H_kv 2, bf16, causal.
LOOP_WIDE_DIMS = (256, 320)


def loop_wide_timings(fa, card, gen, d):
    """{kernel: ms} of the three static kernels at head dim ``d`` (B 1,
    S 4096, H 8 / 2, bf16, causal), each with its bound (operations, at
    the f32 rate: the loop multiplies on the CUDA cores). The times are
    wall times on the card's stream (CUDA events)."""
    shape = (1, TRAIN_SEQ, 8, 2, d, torch.bfloat16, True, None)
    args = bwd_inputs(fa, card, gen, *shape)
    check(not fa.tensor_core_route(*args[:4]),
          f"D {d} took the tensor cores")
    ms = {"flash_fwd": time_ms(lambda: fa.flash_attention(*args[:3]), 3),
          "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(*args), 3),
          "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(*args), 3)}
    work = backward_work(*shape)
    work["flash_fwd"] = attention_work(*shape)
    for name, t in ms.items():
        b_ms, by = bound(*work[name], torch.float32)
        print(f"kernel {name} on the loop at D {d} (B 1, S 4096, H 8/2, "
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
        (1, 200, 4, 2, 320, torch.bfloat16, 200, 150),  # D 320, dead rows
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


# Ulysses' shard shape on the SP path: the SP model's q over a local
# axis of SP_RING, H 16 / H_kv 4 cut to H 4 / H_kv 1 a shard, over the
# whole sequence of 2 x 8192 at the window.
ULYSSES_SHAPE = (SP_BATCH, SP_SEQ, 16 // SP_RING, 4 // SP_RING, 128)


def ulysses_views(card, gen, b):
    """Shard 1's q, k and v as Ulysses hands them to the kernels: head
    slices of a (B, S, 16, D) q and of the (B, S, 2, 4, D) kv
    projection, their base pointers (H/n)*D elements on."""
    _, s, h, h_kv, d = ULYSSES_SHAPE
    q = torch.randn(b, s, h * SP_RING, d, generator=gen, device=card).to(
        torch.bfloat16)
    kv = torch.randn(b, s, 2, h_kv * SP_RING, d, generator=gen,
                     device=card).to(torch.bfloat16)
    views = (q[:, :, h:2 * h], kv[:, :, 0, h_kv:2 * h_kv],
             kv[:, :, 1, h_kv:2 * h_kv])
    check(all(not x.is_contiguous() for x in views)
          and views[0].data_ptr() == q.data_ptr() + h * d * 2,
          "the Ulysses views are not head slices")
    return views


def phase_ulysses_kernels(fa, card, gen, entries):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv at Ulysses' shard shape
    (B 2, S 8192, H 4, H_kv 1, D 128, bf16, causal, window 4096) on
    head-sliced views, against their plain versions at the phase's
    tolerances (the backward's at B 1), and timed beside SDPA with the
    window as a boolean mask at B 2. Adds ``ulysses_shape`` to each
    kernel's entry of the kernels line (``entries`` by name)."""
    b, s, h, h_kv, d = ULYSSES_SHAPE
    dtype, window = torch.bfloat16, SP_WINDOW
    q, k, v = ulysses_views(card, gen, b)
    check(fa.tensor_core_route(q, k, v),
          "Ulysses' head slices do not take the tensor cores")
    before = read_launches(fa)
    out, lse = fa.flash_attention_with_lse(q, k, v, True, window)
    torch.cuda.synchronize()
    check(read_launches(fa)["flash_fwd_wgmma"]
          == before["flash_fwd_wgmma"] + 1,
          "flash_fwd on Ulysses' views was not counted on the tensor cores")
    err, _, _, text = hold_forward(fa, "flash_attention", out, lse,
                                   (q, k, v), (True, window), (True, window))
    print(f"kernel flash_fwd Ulysses shard B={b} S={s} H={h} H_kv={h_kv} "
          f"D={d} window={window}, head-sliced views [tensor cores]: {text}",
          flush=True)
    errs = {"flash_fwd": err}
    do = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    one = tuple(x[:1] for x in args)   # the plain backward at B 1
    check(fa.tensor_core_route(*one[:4]),
          "the Ulysses backward does not take the tensor cores")
    got = {"flash_bwd_dq": (fa.flash_bwd_dq(*one, True, window),),
           "flash_bwd_dkv": fa.flash_bwd_dkv(*one, True, window)}
    torch.cuda.synchronize()
    line = []
    for name in got:
        errs[name], _, _, text = hold_backward(fa, name, got[name], one,
                                               (True, window), (True, window))
        line.append(text)
    print(f"kernel backward Ulysses shard B=1 S={s} H={h} H_kv={h_kv} D={d} "
          f"window={window} [tensor cores]: " + "; ".join(line), flush=True)
    del got
    ms = {"flash_fwd": time_ms(lambda: fa.flash_attention(q, k, v, True,
                                                          window), 10),
          "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(
              *args, True, window), 5),
          "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(
              *args, True, window), 5)}
    plain = {"flash_fwd": time_ms(lambda: fa.flash_attention_reference(
        q, k, v, True, window, operand_dtype=dtype), 1),
             "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq_reference(
                 *one, True, window, operand_dtype=dtype), 1),
             "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv_reference(
                 *one, True, window, operand_dtype=dtype), 1)}
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(h // h_kv, dim=2).transpose(1, 2)
              .detach().requires_grad_() for x in (k, v))
    g = do.transpose(1, 2)
    pos = torch.arange(s, device=card)
    gap = pos[:, None] - pos[None, :]
    mask = (gap >= 0) & (gap < window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), 5)
    lib_both = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, attn_mask=mask), (qt, kt, vt), g), 5)
    work = backward_work(b, s, h, h_kv, d, dtype, True, window)
    work["flash_fwd"] = attention_work(b, s, h, h_kv, d, dtype, True, window)
    for name in ms:
        bound_ms, bound_by = bound(*work[name], dtype)
        lib = lib_fwd if name == "flash_fwd" else lib_both - lib_fwd
        entries[name]["ulysses_shape"] = {
            "shape": f"B {b}, S {s}, H {h} / H_kv {h_kv}, D {d}, window "
                     f"{window}, head-sliced views",
            "ms": ms[name], "plain_ms": plain[name],
            "plain_shape": "B 2" if name == "flash_fwd" else "B 1",
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "library": "scaled_dot_product_attention with the window as a "
                       "boolean attn_mask" + ("" if name == "flash_fwd" else
                                              " (backward: dq, dk, dv)"),
            "max_abs_err": errs[name]}
        print(f"kernel {name} timing at Ulysses' shard shape: {ms[name]:.4f}"
              f" ms, plain {plain[name]:.4f} ms, SDPA {lib:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; "
              f"{work[name][1] / ms[name] / 1e9:.1f} TFLOP/s)", flush=True)
    del q, k, v, out, lse, do, delta, args, one, qt, kt, vt, g, mask
    torch.cuda.empty_cache()


def phase_sp_parity(tfm, RingAxis, card):
    """One step's loss and gradients through the sp-4 ring and through
    Ulysses over a local axis of 4, each against the model without SP
    at the same window, full width on one batch of 2 x 8192, with each
    run's peak memory; and a small f32 model's ring (flash tiles, band
    tiles with rows that see no key, a pruned ring) and Ulysses (the
    CUDA-core loop at H/4 heads) against dense attention. Ulysses' shards
    hold whole GQA groups and the kernels compute each head alone, so
    its run should equal the unsharded one bit for bit but where the
    products around the attention differ: the phase prints max|d| and
    the leaves that are bitwise equal."""
    rng = np.random.default_rng(4)
    # 8 / 4 heads: Ulysses over 4 shards needs the K/V heads to divide
    small = dict(vocab_size=256, d_model=128, n_heads=8, n_kv_heads=4,
                 n_layers=2, d_ff=256, max_seq=256, positional="rope",
                 attention_window=100)
    # (name, attention impl, sp_impl or None without SP); the second run
    # is the yardstick of the others
    runs = (("full width 2 x 8192", SP_MODEL, SP_BATCH, SP_SEQ,
             torch.bfloat16, (("ring", "flash", "ring"),
                              ("flash", "flash", None),
                              ("ulysses", "flash", "ulysses"))),
            ("small f32", small, 2, 256, torch.float32,
             (("ring", "flash", "ring"), ("dense", "dense", None),
              ("ulysses", "flash", "ulysses"))))
    for label, kw, batch, seq, dtype, triple in runs:
        tokens = torch.from_numpy(rng.integers(0, kw["vocab_size"],
                                               (batch, seq))).to(card)
        targets = torch.roll(tokens, -1, dims=1)
        params, loss, grads, peak = None, {}, {}, {}
        for name, impl, sp_impl in triple:
            cfg = tfm.TransformerConfig(dtype=dtype, attention_impl=impl,
                                        sp_impl=sp_impl or "ring",
                                        loss_chunk=min(LOSS_CHUNK, seq), **kw)
            if params is None:
                params = tfm.init_params(cfg, torch.Generator().manual_seed(5),
                                         card)
            axes = (None if sp_impl is None
                    else tfm.ShardAxes(sp=RingAxis.local(SP_RING)))
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
        b = triple[1][0]
        for a in (triple[0][0], triple[2][0]):
            dl = abs(loss[a] - loss[b])
            diff = {k: (grads[a][k] - grads[b][k]).abs().max().item()
                    for k in grads[b]}
            same = sum(d == 0.0 for d in diff.values())
            err = max(diff.values())
            head = (f"parity sp {label}: {a} vs {b}: loss {loss[a]:.6f} vs "
                    f"{loss[b]:.6f} (|d|={dl:.3g}); max|dgrad|={err:.3g}, "
                    f"{same} of {len(diff)} leaves bitwise equal"
                    + (" (loss too)" if dl == 0.0 else ""))
            if dtype == torch.float32:
                print(f"{head} (tol {SMALL_GRAD_ATOL:g})", flush=True)
                check(err <= SMALL_GRAD_ATOL and dl <= SMALL_GRAD_ATOL,
                      f"small f32 model: {a} and {b} gradients disagree")
                continue
            rel = _rel_l2(grads[a], grads[b])
            worst = max(rel, key=rel.get)
            print(f"{head}; loss tol {TRAIN_LOSS_ATOL:g}; gradient "
                  f"relative L2 worst {rel[worst]:.4g} at {worst} (tol "
                  f"{TRAIN_GRAD_REL:g}), median "
                  f"{float(np.median(list(rel.values()))):.4g}; peak memory "
                  f"of loss and backward above what was allocated before "
                  f"(the new gradients included): {a} "
                  f"{peak[a] / 2 ** 30:.2f} GiB, {b} "
                  f"{peak[b] / 2 ** 30:.2f} GiB", flush=True)
            check(dl <= TRAIN_LOSS_ATOL, f"{a} and {b} losses disagree")
            check(rel[worst] <= TRAIN_GRAD_REL,
                  f"{a} and {b} gradients disagree")
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
    # an MoE layer: the router and the top_k experts a token is sent to
    p_mm += sum(layer["moe"]["w_router"].numel() + cfg.moe_top_k
                * (layer["moe"]["w1"].numel() + layer["moe"]["w2"].numel())
                // cfg.moe_num_experts
                for layer in params["layers"] if "moe" in layer)
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


def phase_train(hvd, fa, tfm, card, where, ring=None, sp_impl="ring"):
    """Main path 2 (``ring`` None: batch 4 x 4096), 3 (``ring`` a
    RingAxis: the SP model at batch 2 x 8192 through the ring) or 12
    (the same through Ulysses, ``sp_impl="ulysses"``): init ->
    broadcast_parameters -> DistributedOptimizer -> loss_fn, warm-up plus
    timed steps on one batch, counts zeroed around it. Returns ({kernel:
    launches}, {"step_ms", "tok_s", "peak"}: the median timed step, its
    tokens/s and the peak memory)."""
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
        label = "sp train" if sp_impl == "ring" else "ulysses train"
        batch, seq, model = SP_BATCH, SP_SEQ, SP_MODEL
        axes = tfm.ShardAxes(sp=ring)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, sp_impl=sp_impl,
                                **model)
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
    # shard (the ring's diagonal tiles, Ulysses' head slices), one of
    # each band kernel per live visiting tile of the ring; every launch
    # on the tensor-core route, none on the loop
    shards = 1 if ring is None else len(ring.shards)
    bands = 0 if ring is None or sp_impl != "ring" else len(SP_BAND_OFFSETS)
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
          f"{'' if ring is None else f' over {ring} ({sp_impl}), window '}"
          f"{'' if ring is None else SP_WINDOW}, "
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
    return launches, {"step_ms": median, "tok_s": tok_s, "peak": peak}


COMPILED_STEPS, REPLAYS = 3, 4


def to_card(tree, card):
    """A copy of a parameter tree (dicts, lists of layers) on the card."""
    if isinstance(tree, dict):
        return {k: to_card(v, card) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_card(v, card) for v in tree]
    return tree.to(card, copy=True)


def phase_compiled_train(hvd, fa, tfm, card, where, model=FLAGSHIP,
                         label="compiled train", expert_keys=None,
                         init=None, shape=(TRAIN_BATCH, TRAIN_SEQ),
                         axes=None, per_replay=None):
    """Main path 6 (``model`` the flagship) or 7 (flagship-moe, with
    ``expert_keys``): the model at batch 4 x 4096 through
    ``compiled_train_step`` over ``DistributedOptimizer(AdamW(...,
    capturable=True))``, under HOROVOD_PROFILER_JIT_CALLBACKS=1. First
    COMPILED_STEPS eager steps of the same optimizer from the same init
    (the last ones timed); then COMPILED_STEPS compiled steps (the
    first runs eagerly and captures the graph, the rest replay it), whose
    parameters must equal the eager run's bitwise, with 1 cache miss, the
    rest hits and no fallback; then REPLAYS timed replays, each with 8
    launches of each static kernel on the tensor-core route and the
    eager path's one all-reduce a bucket (a bucket a group with expert
    keys: the experts' over the data group, the rest over the world).
    The losses must be finite and fall. ``init`` (a parameter tree on
    the host) starts both runs, else seed 0 does. Main path 13 runs the
    SP model at ``shape`` 2 x 8192 over ``axes`` (a local axis of 4,
    the ring's or Ulysses', ``model``'s ``sp_impl``), each replay with
    ``per_replay`` launches ({route counter: launches}; default one of
    each static kernel a layer). Returns ({kernel:
    launches} of the compiled steps, the trained parameters, the batch,
    {"params": the parameters after COMPILED_STEPS compiled steps on the
    host, by name, "step_ms", "tok_s", "peak": the replays' median, its
    tokens/s and the peak memory})."""
    os.environ["HOROVOD_PROFILER_JIT_CALLBACKS"] = "1"
    hvd.init(device=card)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **model)
    batch, seq = shape
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (batch, seq))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)

    def build():
        lm = tfm.TransformerLM(
            cfg, None if init is None else to_card(init, card),
            generator=torch.Generator().manual_seed(0), device=card,
            axes=axes)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
            named_parameters=lm.named_parameters(), expert_keys=expert_keys)
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
    # one all-reduce per bucket and exchange group (expert or world)
    n_buckets = sum(len({opt._group_of[p] for p in b})
                    for b in opt.exchange_buckets)
    step = hvd.compiled_train_step(lm.loss, opt)
    stats = hvd.runtime.live_state().stats
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(fa)
    runs = [timed(lambda: step(tokens, targets))
            for _ in range(COMPILED_STEPS)]
    torch.cuda.synchronize()
    losses = [x[0].item() for x in runs]
    got = {n: p.detach().cpu() for n, p in lm.named_parameters()}
    deltas = {n: float((got[n] - want[n]).abs().max()) for n in want}
    differ = {n: deltas[n] for n in want if not torch.equal(got[n], want[n])}
    del want
    prog = next(iter(hvd.runtime.live_state().programs._programs.values()))
    jit0 = stats.counter("allreduce_jit")
    replay_launches0 = read_launches(fa)
    replays = [timed(lambda: step(tokens, targets)) for _ in range(REPLAYS)]
    torch.cuda.synchronize()
    launches = read_launches(fa)
    replay_counts = {k: (launches[k] - replay_launches0[k]) / REPLAYS
                     for k in launches}
    jit_calls = stats.counter("allreduce_jit") - jit0
    replay_ms = [a.elapsed_time(b) for _, (a, b), _ in replays]
    host_ms = [h * 1e3 for _, _, h in replays]
    losses += [x[0].item() for x in replays]
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(replay_ms))
    tok_s = batch * seq / (median / 1e3)
    fpt = flops_per_token(lm.params, cfg, seq)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"{label} losses: {' '.join(f'{x:.4f}' for x in losses)} "
          f"(eager {' '.join(f'{x:.4f}' for x in eager_losses)})", flush=True)
    print(f"{label} {batch} x {seq}, {n_params / 1e6:.1f} M "
          f"parameters [{where}]: step {median:.1f} ms (replay, median of "
          f"{REPLAYS}); {tok_s:.1f} tokens/s; {fpt / 1e9:.3f} GFLOP/token "
          f"(active); MFU {fpt * tok_s / PEAK_FLOPS[torch.bfloat16]:.4f} "
          f"against 989 TFLOP/s bf16; peak memory {peak / 2 ** 30:.2f} GiB",
          flush=True)
    print(f"{label} vs eager after {COMPILED_STEPS} steps: "
          f"{len(differ)} of {len(deltas)} parameters differ, max|d| "
          f"{max(deltas.values()):.3g}"
          + (f" (worst {max(differ, key=differ.get)})" if differ else ""),
          flush=True)
    print(f"{label} {batch} x {seq} [{where}]: replay "
          f"{np.median(replay_ms):.1f}"
          f" ms (median of {REPLAYS}; {' '.join(f'{t:.1f}' for t in replay_ms)})"
          f" against eager {np.median(eager_ms):.1f} ms (steps 2-"
          f"{COMPILED_STEPS} of the same optimizer); step() returns in "
          f"{np.median(host_ms):.3f} ms on the host; cache hits "
          f"{step.cache_hits} misses {step.cache_misses} fallbacks "
          f"{step.fallback_steps}; per replay {replay_counts}; "
          f"{jit_calls} allreduce_jit records in {REPLAYS} replays",
          flush=True)
    check(not differ, f"compiled parameters differ from eager: {differ}")
    check(losses[:COMPILED_STEPS] == eager_losses,
          f"losses {losses} vs eager {eager_losses}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: losses not finite or not falling: {losses}")
    check((step.cache_misses, step.fallback_steps) == (1, 0)
          and step.cache_hits == COMPILED_STEPS + REPLAYS - 1,
          f"cache {step.cache_hits}/{step.cache_misses}, fallbacks "
          f"{step.fallback_steps}")
    if per_replay is None:
        per_replay = dict.fromkeys(("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                                    "flash_bwd_dkv_wgmma"), cfg.n_layers)
    for name, n in replay_counts.items():
        want_n = per_replay.get(name, 0)
        check(n == want_n, f"{name}: {n} launches a replay, {want_n} "
                           "expected")
    check(len(prog.collectives) == n_buckets and jit_calls
          == REPLAYS * n_buckets,
          f"all-reduces a replay: {prog.collectives}, {jit_calls} records "
          f"in {REPLAYS} replays of {n_buckets} bucket(s)")
    params = lm.params
    del step, prog, opt
    gc.collect()
    hvd.shutdown()
    os.environ.pop("HOROVOD_PROFILER_JIT_CALLBACKS")
    return launches, params, tokens, {"params": got, "step_ms": median,
                                      "tok_s": tok_s, "peak": peak}


# The phase trace (main path 15): steps traced a window, and its gates.
TRACE_STEPS = 4
TRACE_SUM_REL, TRACE_OTHER_MAX, TRACE_PHASE_REL = 0.01, 0.05, 0.10
TRACE_PHASE_FLOOR, TRACE_SERVE_MIN, TRACE_OVERHEAD_MAX = 0.01, 0.95, 0.01
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_device_us(trace_dir):
    """The device time (us) of every kernel, copy and set in a capture,
    summed straight from its kineto files: the phase join's yardstick."""
    total = 0.0
    for name in os.listdir(trace_dir):
        if name.endswith(".trace.json"):
            with open(os.path.join(trace_dir, name)) as f:
                events = json.load(f)["traceEvents"]
            total += sum(float(e.get("dur") or 0.0) for e in events
                         if e.get("ph") == "X"
                         and e.get("cat") in _DEVICE_CATS)
    return total


def check_trace(label, summary, trace_dir, steps, where, phases=None):
    """Print a traced window's device ms a step by phase, ``other``, its
    device time and ``exchange_hidden_frac``; hold the phases plus other
    to the capture's device time (TRACE_SUM_REL) and, for a step,
    ``other`` under TRACE_OTHER_MAX of it. Returns {phase: ms a step}."""
    check(summary is not None, f"{label}: the capture parsed to nothing")
    total_us = trace_device_us(trace_dir)
    got = summary["total_s"] * 1e6
    per = {p: v * 1e3 / steps for p, v in summary["phases"].items()}
    ex = summary.get("exchange")
    hidden = None if not ex else round(ex["hidden_frac"], 4)
    shown = {p: round(v, 3) for p, v in per.items() if v > 0 or p == "other"}
    lost = sum(g["lost"] for g in summary["graphs"].values())
    print(f"trace {label} [{where}]: device ms a step by phase {shown}; "
          f"device time {total_us / 1e3 / steps:.3f} ms a step over "
          f"{summary['events']} events ({summary['graph_events']} replayed, "
          f"{summary['unmatched']} unmatched, {lost} dropped by the "
          f"profiler) on {summary['lanes']} stream(s); "
          f"exchange_hidden_frac {hidden}", flush=True)
    check(abs(got - total_us) <= TRACE_SUM_REL * total_us,
          f"{label}: phases plus other {got:.1f} us against the capture's "
          f"device time {total_us:.1f} us")
    if phases == "step":
        check(per["other"] * 1e3 * steps <= TRACE_OTHER_MAX * total_us,
              f"{label}: other is {per['other']:.3f} ms of "
              f"{total_us / 1e3 / steps:.3f} ms a step")
        for name, want in (("flash_fwd_wgmma_kernel", "forward"),
                           ("flash_bwd_dq_wgmma_kernel", "backward"),
                           ("flash_bwd_dkv_wgmma_kernel", "backward")):
            where_ = {}
            for k, by in summary["kernels"].items():
                if name in k:
                    for ph, sec in by.items():
                        where_[ph] = where_.get(ph, 0.0) + sec
            check(where_ and set(where_) == {want},
                  f"{label}: {name} lands in {where_}, not {want} alone")
    return per


def phase_trace(hvd, fa, tfm, serve, metrics, card, where, untraced):
    """Main path 15: the phase trace (diag/xla_trace.py) of the flagship
    at 4 x 4096 with capturable AdamW under DistributedOptimizer:

    - a compiled step (warm-up and capture), an untraced replay (its
      launches by route kept), then ``hvd.trace_steps(4)`` over the next
      4 replays, ticked by the step, and one more replay: 7 steps, as
      the compiled train phase runs from the same seed. The traced
      replays' launches by route must equal the untraced one's, and the
      parameters after the 7 steps ``untraced`` (that phase's, on the
      card), bitwise;
    - on that model, 3 eager steps timed for the idle costs (the
      tracer's tick and phase ranges, the flight recorder's events; each
      under 1% of the loop), then ``trace_steps(4)`` over the eager
      step, ticked by ``TelemetryCallback``, its regions under the phase
      ranges as the compiled step's;
    - one graph serve round of the 8 requests, traced.

    Each window's phases plus ``other`` must equal the capture's device
    time within TRACE_SUM_REL; a step's ``other`` stays under
    TRACE_OTHER_MAX; the replay's phases above TRACE_PHASE_FLOOR of the
    step lie within TRACE_PHASE_REL of the eager step's; the flash
    kernels land in forward and backward alone; the serve round keeps
    TRACE_SERVE_MIN of its device time in prefill and decode. Returns
    {kernel: launches} of the compiled run."""
    from torch.profiler import record_function

    from horovod_tpu_torch.bench.resnet import (flight_attribution,
                                                trace_attribution)
    from horovod_tpu_torch.callbacks import TelemetryCallback
    from horovod_tpu_torch.diag import recorder
    diag_dir = tempfile.mkdtemp(prefix="chip-trace-")
    hvd.init(device=card)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (TRAIN_BATCH, TRAIN_SEQ))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
        named_parameters=lm.named_parameters())
    step = hvd.compiled_train_step(lm.loss, opt)

    def replay_counts(calls):
        before = read_launches(fa)
        for _ in range(calls):
            step(tokens, targets)
        torch.cuda.synchronize()
        after = read_launches(fa)
        return {k: (after[k] - before[k]) / calls for k in after}

    zero_launches(fa)
    step(tokens, targets)
    plain = replay_counts(1)
    tracer = hvd.trace_steps(TRACE_STEPS, out_dir=diag_dir)
    traced = replay_counts(TRACE_STEPS + 1)
    launches = read_launches(fa)
    steps = 2 + TRACE_STEPS + 1
    check(steps == COMPILED_STEPS + REPLAYS, f"{steps} steps traced")
    differ = sum(not torch.equal(a, b) for a, b in zip(
        _leaves(lm.params), _leaves(untraced)))
    replay = check_trace("compiled replay", tracer.last_summary,
                         tracer.last_dir, TRACE_STEPS, where, "step")
    flops = step.flops_per_step
    print(f"trace compiled replay: launches a replay {traced} (untraced "
          f"{plain}); {differ} parameters differ from the untraced "
          f"run's after {steps} steps; {flops / 1e12:.3f} TFLOP a step "
          f"(FlopCounterMode and the flash kernels' own counts)",
          flush=True)
    check(traced == plain, f"traced replays launch {traced}, untraced "
                           f"{plain}")
    check(not differ, f"tracing changed {differ} parameters")

    def eager_step():
        opt.zero_grad(set_to_none=True)
        with record_function("hvd_forward"):
            loss = lm.loss(tokens, targets)
        with record_function("hvd_backward"):
            loss.backward()
        with record_function("hvd_optimizer"):
            opt.step()
        torch.cuda.synchronize()

    eager_step()
    flight = recorder.get()
    phase0, events0 = flight.phase_totals(), flight.events_recorded
    t0 = time.perf_counter()
    for _ in range(3):
        eager_step()
    loop_wall = time.perf_counter() - t0
    _, flight_frac = flight_attribution(flight, phase0, events0, loop_wall, 3)
    trace_frac = trace_attribution(loop_wall, 3)  # 5 phase ranges a step
    step_ms = loop_wall / 3 * 1e3
    tracer = hvd.trace_steps(TRACE_STEPS, out_dir=diag_dir)
    cb = TelemetryCallback(batch_size=TRAIN_BATCH, skew_interval=0)
    for i in range(TRACE_STEPS + 1):
        cb.on_batch_begin(i)
        eager_step()
        cb.on_batch_end(i)
    check(not tracer.active and tracer.captures == 2,
          f"the eager window did not close: {tracer.captures} captures")
    eager = check_trace("eager step", tracer.last_summary, tracer.last_dir,
                        TRACE_STEPS, where, "step")
    mfu = flops / (step_ms / 1e3 * PEAK_FLOPS[torch.bfloat16])
    print(f"trace flagship step [{where}]: {step_ms:.1f} ms eager, "
          f"flops_per_step {flops:.6g}, MFU {mfu:.4f} against 989 TFLOP/s "
          f"bf16; idle costs over the loop: trace_overhead_frac "
          f"{trace_frac:.6f}, flight_overhead_frac {flight_frac:.6f}",
          flush=True)
    check(trace_frac < TRACE_OVERHEAD_MAX and flight_frac
          < TRACE_OVERHEAD_MAX, f"idle costs {trace_frac}, {flight_frac}")
    total = sum(eager.values())
    for ph, ms in eager.items():
        if ph != "other" and ms > TRACE_PHASE_FLOOR * total:
            check(abs(replay[ph] - ms) <= TRACE_PHASE_REL * ms,
                  f"{ph}: replay {replay[ph]:.3f} ms against eager "
                  f"{ms:.3f} ms a step")
    del lm, opt, step, untraced
    gc.collect()
    torch.cuda.empty_cache()

    lm = tfm.TransformerLM(tfm.TransformerConfig(
        dtype=torch.bfloat16, attention_impl="flash", **FLAGSHIP),
        generator=torch.Generator().manual_seed(0), device=card)
    with step_program("1"):
        engine = serve.Engine(lm, lm.params, page_size=PAGE_SIZE,
                              max_batch=N_REQUESTS, start=False,
                              device=card)
        serve_round(engine, metrics, lm.cfg.vocab_size)
        tracer = hvd.trace_steps(1, out_dir=diag_dir)
        tracer.tick(owner=phase_trace)
        serve_round(engine, metrics, lm.cfg.vocab_size)
        tracer.tick(owner=phase_trace)
        engine.close()
    summary = tracer.last_summary
    served = check_trace("graph serve round", summary, tracer.last_dir, 1,
                         where)
    share = (served["prefill"] + served["decode"]) / sum(served.values())
    print(f"trace graph serve round: prefill and decode hold {share:.4f} "
          f"of its device time", flush=True)
    check(share >= TRACE_SERVE_MIN, f"serve round: {share:.4f} in prefill "
                                    f"and decode")
    del engine, lm
    gc.collect()
    hvd.shutdown()
    torch.cuda.empty_cache()
    shutil.rmtree(diag_dir, ignore_errors=True)
    return launches


# Pipeline parallelism: the flagship's 8 layers over a local pp axis of
# 4 stages (2 layers a stage, 1 a chunk interleaved at V 2), the
# training batch 4 x 4096 in 4 microbatches of 1 x 4096.
PP_STAGES, PP_MICROBATCHES, PP_STEPS = 4, 4, 3


def _pp_want(tfm, grads, cfg, interleave=1):
    """The unpipelined gradients (``_flat_grads`` names) in the stacked
    layout's names and shapes (layer (c*S + s)*L' + l at [c, s, l])."""
    want = {k: g for k, g in grads.items() if not k.startswith("layers.")}
    for k in {n.split(".", 2)[2] for n in grads if n.startswith("layers.")}:
        g = torch.stack([grads[f"layers.{i}.{k}"]
                         for i in range(cfg.n_layers)])
        if interleave > 1:
            g = g.reshape((interleave, PP_STAGES, -1) + tuple(g.shape[1:]))
        want[f"layers.{k}"] = g
    return want


def _pp_run(tfm, fa, cfg, stacked, tokens, targets, schedule, interleave=1):
    """(loss, {name: gradient}, launches, peak above the allocation
    before) of one pipelined loss and backward over the local pp axis:
    GPipe under autograd, or 1F1B's own gradients."""
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    pp = RingAxis.local(PP_STAGES)
    for t in tfm._leaves(stacked):
        t.grad = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(fa)
    if schedule == "gpipe":
        loss = tfm.pipeline_loss_fn(stacked, tokens, targets, cfg,
                                    num_microbatches=PP_MICROBATCHES, pp=pp)
        loss.backward()
        grads = {k: t.grad for k, t in tfm._named_leaves(stacked)}
    else:
        loss, tree = tfm.pipeline_value_and_grad_1f1b(
            stacked, tokens, targets, cfg, num_microbatches=PP_MICROBATCHES,
            pp=pp, interleave=interleave)
        grads = dict(tfm._named_leaves(tree))
    torch.cuda.synchronize()
    return (loss.item(), grads, read_launches(fa),
            torch.cuda.max_memory_allocated() - base)


def pp_launches(cfg, schedule):
    """One pipelined step's launches of each static kernel on the tensor
    cores, by the port's rule (parallel/pipeline.py: inactive slots
    skipped): every (stage, microbatch) runs its layers' forward once
    under GPipe, twice under 1F1B (the forward phase and the backward
    phase's recompute), and their backward once."""
    fwd = cfg.n_layers * PP_MICROBATCHES
    return {"flash_fwd_wgmma": fwd * (1 if schedule == "gpipe" else 2),
            "flash_bwd_dq_wgmma": fwd, "flash_bwd_dkv_wgmma": fwd}


def phase_pipeline(fa, tfm, card, where):
    """Main path 14: the flagship over a local pp axis of PP_STAGES on
    this card, batch 4 x 4096 in PP_MICROBATCHES microbatches, loss
    chunk 512. Parity: GPipe (``pipeline_loss_fn`` under autograd), 1F1B
    at V 1 and at V 2 (one layer a chunk) against the unpipelined
    ``loss_fn`` on one batch (loss within TRAIN_LOSS_ATOL, every
    gradient within TRAIN_GRAD_REL), and a small f32 model's three
    within SMALL_GRAD_ATOL. Then PP_STEPS AdamW steps of the
    unpipelined model, of GPipe and of 1F1B from the same weights, each
    loss falling, with step times (a local schedule on one card, not a
    PP speed), peak memory (1F1B's below GPipe's) and each pipelined
    step's launches exactly as ``pp_launches`` says. Returns ({kernel:
    launches} of GPipe's steps, of 1F1B's)."""
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    rng = np.random.default_rng(6)
    small = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
                 n_layers=8, d_ff=256, max_seq=128, positional="rope")
    for label, kw, batch, seq, dtype in (
            ("full width 4 x 4096", FLAGSHIP, TRAIN_BATCH, TRAIN_SEQ,
             torch.bfloat16),
            ("small f32", small, 4, 128, torch.float32)):
        cfg = tfm.TransformerConfig(dtype=dtype, attention_impl="flash",
                                    loss_chunk=min(LOSS_CHUNK, seq), **kw)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (batch, seq))).to(card)
        targets = torch.roll(tokens, -1, dims=1)
        params = tfm.init_params(cfg, torch.Generator().manual_seed(7), card)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ref_loss, g = _loss_and_grads(tfm, params, cfg, tokens, targets)
        ref_peak = torch.cuda.max_memory_allocated() - base
        grads = {k: v.float().clone() for k, v in g.items()}
        del g
        for t in _leaves(params):
            t.grad = None
            t.requires_grad_(False)
        peaks = {"unpipelined": ref_peak}
        for name, schedule, v in (("gpipe", "gpipe", 1), ("1f1b", "1f1b", 1),
                                  ("1f1b V 2", "1f1b", 2)):
            stacked = tfm.stack_pipeline_params(params, interleave=v,
                                                num_stages=PP_STAGES)
            for t in tfm._leaves(stacked):
                t.requires_grad_()
            loss, got, launches, peaks[name] = _pp_run(
                tfm, fa, cfg, stacked, tokens, targets, schedule, v)
            want = _pp_want(tfm, grads, cfg, v)
            dl = abs(loss - ref_loss)
            head = (f"parity pp {label} {name} vs unpipelined: loss "
                    f"{loss:.6f} vs {ref_loss:.6f} (|d|={dl:.3g})")
            if dtype == torch.float32:
                err = max((got[k].float() - want[k]).abs().max().item()
                          for k in want)
                print(f"{head}; max|dgrad|={err:.3g} (tol "
                      f"{SMALL_GRAD_ATOL:g})", flush=True)
                check(err <= SMALL_GRAD_ATOL and dl <= SMALL_GRAD_ATOL,
                      f"small f32 pipeline {name} disagrees with loss_fn")
            else:
                rel = _rel_l2({k: got[k].float() for k in want}, want)
                worst = max(rel, key=rel.get)
                print(f"{head} (tol {TRAIN_LOSS_ATOL:g}); gradient relative "
                      f"L2 worst {rel[worst]:.4g} at {worst} (tol "
                      f"{TRAIN_GRAD_REL:g}), median "
                      f"{float(np.median(list(rel.values()))):.4g}; peak "
                      f"above the weights {peaks[name] / 2 ** 30:.2f} GiB "
                      f"(unpipelined {ref_peak / 2 ** 30:.2f}); launches "
                      f"{launches}", flush=True)
                check(dl <= TRAIN_LOSS_ATOL,
                      f"pipeline {name} loss disagrees with loss_fn")
                check(rel[worst] <= TRAIN_GRAD_REL,
                      f"pipeline {name} gradients disagree with loss_fn")
                want_n = pp_launches(cfg, schedule)
                check(all(launches[k] == want_n.get(k, 0) for k in launches),
                      f"pipeline {name} launches {launches}, {want_n} "
                      "expected")
            del stacked, got, want
        del params, grads
        torch.cuda.empty_cache()

    # ---- training: PP_STEPS AdamW steps of each schedule
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (TRAIN_BATCH, TRAIN_SEQ))).to(card)
    targets = torch.roll(tokens, -1, dims=1)
    init = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    stats, paths = {}, {}
    for schedule in ("unpipelined", "gpipe", "1f1b"):
        params = to_card(init, card)
        if schedule != "unpipelined":
            params = tfm.stack_pipeline_params(params,
                                               num_stages=PP_STAGES)
        leaves = list(tfm._leaves(params))
        for t in leaves:
            t.requires_grad_()
        opt = torch.optim.AdamW(leaves, **ADAMW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(fa)
        losses, events = [], []
        for _ in range(PP_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            opt.zero_grad(set_to_none=True)
            if schedule == "1f1b":
                loss, tree = tfm.pipeline_value_and_grad_1f1b(
                    params, tokens, targets, cfg,
                    num_microbatches=PP_MICROBATCHES,
                    pp=RingAxis.local(PP_STAGES))
                for (_, t), (_, g) in zip(tfm._named_leaves(params),
                                          tfm._named_leaves(tree)):
                    t.grad = g
                del tree
            else:
                if schedule == "gpipe":
                    loss = tfm.pipeline_loss_fn(
                        params, tokens, targets, cfg,
                        num_microbatches=PP_MICROBATCHES,
                        pp=RingAxis.local(PP_STAGES))
                else:
                    loss = tfm.loss_fn(params, tokens, targets, cfg)
                loss.backward()
            opt.step()
            end.record()
            events.append((start, end))
            losses.append(loss.detach())
        torch.cuda.synchronize()
        launches = read_launches(fa)
        losses = [x.item() for x in losses]
        step_ms = [a.elapsed_time(b) for a, b in events]
        peak = torch.cuda.max_memory_allocated()
        stats[schedule] = (step_ms, peak)
        print(f"pp train {schedule} [{where}] (a local schedule of "
              f"{PP_STAGES} stages on one card, not a PP speed): 4 x 4096 "
              f"in {PP_MICROBATCHES} microbatches, steps "
              f"{' '.join(f'{t:.1f}' for t in step_ms)} ms, losses "
              f"{' '.join(f'{x:.4f}' for x in losses)}, peak memory "
              f"{peak / 2 ** 30:.2f} GiB; launches {launches}", flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"pp train {schedule}: losses not finite or not falling: "
              f"{losses}")
        if schedule != "unpipelined":
            want_n = {k: PP_STEPS * n
                      for k, n in pp_launches(cfg, schedule).items()}
            check(all(launches[k] == want_n.get(k, 0) for k in launches),
                  f"pp train {schedule} launches {launches}, {want_n} "
                  "expected")
            paths[schedule] = launches
        del params, leaves, opt
        gc.collect()
        torch.cuda.empty_cache()
    stash_mib = (2 * PP_STAGES - 1) * TRAIN_SEQ * cfg.d_model * 2 / 2 ** 20
    gib = {k: v[1] / 2 ** 30 for k, v in stats.items()}
    print(f"pp train peaks: unpipelined {gib['unpipelined']:.2f} GiB, GPipe "
          f"{gib['gpipe']:.2f} GiB, 1F1B {gib['1f1b']:.2f} GiB (a stage "
          f"stashes at most "
          f"{2 * PP_STAGES - 1} inputs of 1 x {TRAIN_SEQ} x {cfg.d_model} "
          f"bf16, {stash_mib:.0f} MiB); 1F1B below GPipe: "
          f"{stats['1f1b'][1] < stats['gpipe'][1]}", flush=True)
    check(stats["1f1b"][1] < stats["gpipe"][1],
          "1F1B's peak memory is not below GPipe's")
    return paths["gpipe"], paths["1f1b"]


ZERO_STAGES = (1, 2, 3)
# Each stage's peak memory at 4 x 4096 when it ran in a session of its
# own (GiB; this phase before the stages shared a session, on an NVIDIA
# H100 80GB HBM3 at 700 W): in one session a stage may not read more
# than ZERO_PEAK_SLACK_GIB above it, as it did while dropped steps stayed
# in the program cache (+9.1 GiB a stage).
ZERO_SESSION_PEAK_GIB = {1: 25.89, 2: 25.96, 3: 26.02}
ZERO_PEAK_SLACK_GIB = 0.5


def phase_zero_train(hvd, fa, tfm, metrics, card, where, stage0):
    """Main path 9: the flagship at 4 x 4096 through
    ``DistributedOptimizer(AdamW(..., capturable=True), zero_stage=s)``
    for s in 1, 2, 3, one rank: COMPILED_STEPS eager steps, then
    COMPILED_STEPS compiled steps and REPLAYS replays from the same start
    (seed 0, drawn once on the host). The parameters after
    COMPILED_STEPS steps must equal, bit for bit, both the eager run's
    and stage 0's compiled run's (``stage0``, from
    :func:`phase_compiled_train`: at one rank the scatter and the gather
    are copies, the division is by 1 and AdamW is elementwise); zero3's
    are read through ``unshard_params``, and its
    ``unshard_params(shard_params(p))`` must be ``p``. Each stage: 1
    cache miss, 0 fallbacks, per replay 8 launches of each static kernel
    on the tensor-core route and one ``reducescatter_jit`` and one
    ``allgather_jit`` a chunk. Prints step time, tokens/s, peak memory
    and the ``hvd_zero_stripe_bytes`` gauges beside stage 0's. The three
    stages run in one session: a dropped step's program leaves the
    session's cache with its model and optimizer, so each stage's peak
    must lie within ZERO_PEAK_SLACK_GIB of the peak it reached in a
    session of its own (ZERO_SESSION_PEAK_GIB). Returns {kernel:
    launches} of the compiled steps, summed over the stages."""
    print("zero train: no staged step on this card: two DCN stages need "
          "two ranks at least and NCCL refuses two ranks on one card, so "
          "the staged exchange and its bf16/int8 hops are checked on the "
          "CPU over gloo only (tests/test_torch_zero.py, "
          "tests/test_torch_sharding_spec.py)", flush=True)
    os.environ["HOROVOD_PROFILER_JIT_CALLBACKS"] = "1"
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    init = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (TRAIN_BATCH, TRAIN_SEQ))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)
    total = {}

    def build(stage):
        lm = tfm.TransformerLM(cfg, to_card(init, card), device=card)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
            named_parameters=lm.named_parameters(), zero_stage=stage)
        return lm, opt

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = fn()
        end.record()
        return loss, (start, end)

    hvd.init(device=card)
    stats = hvd.runtime.live_state().stats
    for stage in ZERO_STAGES:
        t0 = time.perf_counter()
        lm, opt = build(stage)
        eager_losses = []
        for _ in range(COMPILED_STEPS):
            opt.zero_grad(set_to_none=True)
            loss = lm.loss(tokens, targets)
            loss.backward()
            opt.step()
            eager_losses.append(loss.detach())
        want = {n: p.detach().cpu() for n, p in lm.named_parameters()}
        eager_losses = [x.item() for x in eager_losses]
        del lm, opt, loss
        gc.collect()
        torch.cuda.empty_cache()

        lm, opt = build(stage)
        names = [n for n, _ in lm.named_parameters()]
        step = hvd.compiled_train_step(lm.loss, opt)
        if stage == 3:
            start = [p.detach().clone() for p in lm.parameters()]
            back = step.unshard_params(step.shard_params())
            check(all(torch.equal(a, b) for a, b in zip(start, back)),
                  "zero3: unshard_params(shard_params(p)) != p")
            del start, back
        chunks = len(opt.exchange_buckets)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(fa)
        runs = [timed(lambda: step(tokens, targets))
                for _ in range(COMPILED_STEPS)]
        torch.cuda.synchronize()
        losses = [x[0].item() for x in runs]
        now = (step.unshard_params() if stage == 3
               else [p.detach() for p in lm.parameters()])
        got = {n: t.cpu() for n, t in zip(names, now)}
        del now
        vs_eager = [n for n in names if not torch.equal(got[n], want[n])]
        vs_stage0 = [n for n in names
                     if not torch.equal(got[n], stage0["params"][n])]
        del got, want
        prog = list(hvd.runtime.live_state().programs._programs.values())[-1]
        rs0, ag0 = (stats.counter("reducescatter_jit"),
                    stats.counter("allgather_jit"))
        launches0 = read_launches(fa)
        replays = [timed(lambda: step(tokens, targets))
                   for _ in range(REPLAYS)]
        torch.cuda.synchronize()
        launches = read_launches(fa)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        per_replay = {k: (launches[k] - launches0[k]) / REPLAYS
                      for k in launches}
        rs = (stats.counter("reducescatter_jit") - rs0) / REPLAYS
        ag = (stats.counter("allgather_jit") - ag0) / REPLAYS
        losses += [x[0].item() for x in replays]
        replay_ms = [a.elapsed_time(b) for _, (a, b) in replays]
        median = float(np.median(replay_ms))
        peak = torch.cuda.max_memory_allocated()
        gauges = metrics.ZERO_STRIPE_BYTES.collect()
        stripe = opt.stripe.numel()
        print(f"zero{stage} train {TRAIN_BATCH} x {TRAIN_SEQ} [{where}]: "
              f"step {median:.1f} ms (replay, median of {REPLAYS}; "
              f"{' '.join(f'{t:.1f}' for t in replay_ms)}) against stage "
              f"0's {stage0['step_ms']:.1f} ms; "
              f"{TRAIN_BATCH * TRAIN_SEQ / (median / 1e3):.1f} tokens/s "
              f"against {stage0['tok_s']:.1f}; peak memory "
              f"{peak / 2 ** 30:.2f} GiB against "
              f"{stage0['peak'] / 2 ** 30:.2f} GiB; stripe {stripe} elements in {chunks} chunk(s); "
              f"hvd_zero_stripe_bytes {gauges}; per replay {per_replay}, "
              f"{rs} reducescatter_jit and {ag} allgather_jit records; "
              f"cache hits {step.cache_hits} misses {step.cache_misses} "
              f"fallbacks {step.fallback_steps}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print(f"zero{stage} train losses: "
              f"{' '.join(f'{x:.4f}' for x in losses)} (eager "
              f"{' '.join(f'{x:.4f}' for x in eager_losses)}); after "
              f"{COMPILED_STEPS} steps {len(vs_eager)} of {len(names)} "
              f"parameters differ from eager, {len(vs_stage0)} from stage "
              "0", flush=True)
        check(not vs_eager, f"zero{stage}: compiled differs from eager: "
                            f"{vs_eager}")
        check(not vs_stage0, f"zero{stage}: differs from stage 0: "
                             f"{vs_stage0}")
        check(losses[:COMPILED_STEPS] == eager_losses,
              f"zero{stage}: losses {losses} vs eager {eager_losses}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"zero{stage}: losses not finite or not falling: {losses}")
        check((step.cache_misses, step.fallback_steps) == (1, 0)
              and step.cache_hits == COMPILED_STEPS + REPLAYS - 1,
              f"zero{stage}: cache {step.cache_hits}/{step.cache_misses}, "
              f"fallbacks {step.fallback_steps}")
        for name, n in per_replay.items():
            want_n = cfg.n_layers if name in (
                "flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                "flash_bwd_dkv_wgmma") else 0
            check(n == want_n, f"zero{stage} {name}: {n} launches a "
                               f"replay, {want_n} expected")
        ops = sorted(op for op, _ in prog.collectives)
        check(ops == ["allgather_jit"] * chunks
              + ["reducescatter_jit"] * chunks and rs == ag == chunks,
              f"zero{stage}: a replay records {ops}; {rs}/{ag} a replay, "
              f"{chunks} chunk(s)")
        check(gauges['kind="grads"'] == stripe * 4
              and gauges['kind="params"'] == (stripe * 4 if stage == 3
                                              else 0)
              and gauges['kind="opt"'] == 2 * stripe * 4 + 4,
              f"zero{stage}: gauges {gauges} for a stripe of {stripe}")
        alone = ZERO_SESSION_PEAK_GIB[stage]
        print(f"zero{stage} peak in one session with the earlier stages: "
              f"{peak / 2 ** 30:.2f} GiB against {alone:.2f} GiB in a "
              f"session of its own (slack {ZERO_PEAK_SLACK_GIB} GiB); "
              f"programs cached {len(hvd.runtime.live_state().programs)}",
              flush=True)
        check(abs(peak / 2 ** 30 - alone) <= ZERO_PEAK_SLACK_GIB,
              f"zero{stage}: peak {peak / 2 ** 30:.2f} GiB in one session, "
              f"{alone:.2f} GiB alone")
        del step, prog, opt, lm
        gc.collect()
        torch.cuda.empty_cache()
        check(len(hvd.runtime.live_state().programs) == 0,
              f"zero{stage}: the dropped step's program is still cached")
    hvd.shutdown()
    del init
    os.environ.pop("HOROVOD_PROFILER_JIT_CALLBACKS")
    return total


# Tensor parallelism on one card: two processes, one model group, joined
# by gloo (NCCL refuses two ranks on one card; gloo moves card tensors
# through the host). The flagship at full width, each rank holding half
# of every head, FFN and vocabulary stripe: H 8 / H_kv 2 a rank. Serving
# the 8 requests above; training at B 1 x 4096, one step checked against
# the unsharded model and TP_STEPS more AdamW steps.
TP_RANKS, TP_BATCH, TP_STEPS = 2, 1, 3
TP_TIMEOUT_S = 900
# A top-2 gap of the unsharded logits at or below which a bf16 argmax is
# left to the rounding: TP sums ``wo`` and ``w2`` over heads and columns
# in another order, and the bf16 residual carries that. Fixed between
# the largest gap an H100 run flipped at (0.015) and the smallest twice
# a flipped row's max|d| (0.0586); at f32 the tokens must be identical.
TP_NEAR_TIE = 2.0 ** -5


def _gloo_carries_cuda(dist, card):
    """gloo's all_reduce, all_gather and broadcast on card tensors, each
    against its answer on both ranks."""
    r = dist.get_rank()
    x = torch.full((4,), float(r + 1), device=card)
    dist.all_reduce(x)
    parts = [torch.empty(2, device=card) for _ in range(TP_RANKS)]
    dist.all_gather(parts, torch.full((2,), float(r), device=card))
    b = torch.full((3,), float(r + 7), device=card)
    dist.broadcast(b, src=0)
    return (x.tolist() == [3.0] * 4 and b.tolist() == [7.0] * 3
            and [p.tolist() for p in parts] == [[0.0, 0.0], [1.0, 1.0]])


def _tp_greedy(eng):
    """The 8 greedy requests through a batcher on ``eng``: (streams,
    wall seconds, scheduler steps)."""
    from horovod_tpu_torch.serve.scheduler import ContinuousBatcher, Request
    batcher = ContinuousBatcher(eng, max_batch=N_REQUESTS)
    reqs = [Request(p, NEW_TOKENS) for p in prompts(eng.cfg.vocab_size)]
    for q in reqs:
        batcher.submit(q)
    t0 = time.perf_counter()
    batcher.drain()
    return [q.generated for q in reqs], time.perf_counter() - t0, \
        batcher.steps


def _tp_teacher_forced(eng, streams):
    """The logits rows (NEW_TOKENS, 8, V) of the 8 prompts' prefill and
    of NEW_TOKENS - 1 decode steps fed ``streams``, and the prefill's
    time (ms); the pages freed after."""
    ids = list(range(N_REQUESTS))
    for sid in ids:
        eng.cache.allocate(sid, PROMPT_LEN + NEW_TOKENS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [eng.prefill(ids, prompts(eng.cfg.vocab_size))]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    for i in range(NEW_TOKENS - 1):
        rows.append(eng.decode(ids, [s[i] for s in streams],
                               [PROMPT_LEN + i] * N_REQUESTS))
    for sid in ids:
        eng.cache.free(sid)
    return np.stack(rows), prefill_ms


def _tp_serve_checks(rows, ref_rows, tokens, streams):
    """The TP engine against the unsharded one: ``(ok, message)`` pairs.
    Teacher-forced on the unsharded greedy streams, every logit lies
    within LOGITS_ATOL, and the argmax agrees wherever the unsharded
    row's top-2 gap exceeds TP_NEAR_TIE; each free-running TP stream
    equals the unsharded one up to its first difference, and that
    difference is one of those near-ties, teacher-forced."""
    diff = np.abs(rows - ref_rows)
    got, want = rows.argmax(-1), ref_rows.argmax(-1)
    top2 = np.sort(ref_rows, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    row_d = diff.max(-1)
    flips = list(zip(*np.nonzero(got != want)))
    decided = [(int(p), int(i)) for p, i in flips if gap[p, i] > TP_NEAR_TIE]
    first = [next((p for p, (a, b) in enumerate(zip(t, s)) if a != b), None)
             for t, s in zip(tokens, streams)]
    unexplained = [(i, p) for i, p in enumerate(first) if p is not None
                   and (got[p, i] == want[p, i] or got[p, i] != tokens[i][p])]
    print(f"tp serve vs unsharded, teacher-forced on its 8 x {NEW_TOKENS} "
          f"greedy tokens: logits max|d| {float(diff.max()):.4g} (tol "
          f"{LOGITS_ATOL:g}; prefill {float(diff[0].max()):.4g}); argmax "
          f"differs at {len(flips)} of {got.size} positions, top-2 gaps "
          f"{[round(float(gap[p, i]), 4) for p, i in flips]} (near-tie at "
          f"<= {TP_NEAR_TIE:g}; the rows' max|d| "
          f"{[round(float(row_d[p, i]), 4) for p, i in flips]}); "
          f"free-running streams identical {first.count(None)} of "
          f"{len(first)} (first difference at {first})", flush=True)
    return [(np.isfinite(rows).all() and float(diff.max()) <= LOGITS_ATOL,
             "tp logits disagree with the unsharded engine's"),
            (not decided, f"tp argmax differs where the unsharded choice "
                          f"is clear: {decided}"),
            (not unexplained, f"tp streams diverge where teacher forcing "
                              f"agrees: {unexplained}")]


# The f32 leg of TP training: the gathered gradients against the
# unsharded f32 model's differ by the f32 sums' order only (the wo and w2
# psums add two halves where the unsharded product adds one row).
TP_F32_GRAD_REL = 1e-4


def _tp_grad_rel(dist, tfm, grads, specs, tp, rank, want):
    """{leaf: relative L2} on rank 0 of the rank's gradients gathered
    over the model group against ``want`` (the unsharded model's, by
    name, on the host): a model leaf's gradient is tp times its block of
    the unsharded one (the reference's psum transposes to a psum), a
    replicated leaf's the unsharded gradient itself. Collective."""
    rel = {}
    spec_of = dict(tfm._named_leaves(specs))
    for k, g in grads.items():
        if "model" in spec_of[k]:
            parts = [torch.empty_like(g) for _ in range(TP_RANKS)]
            dist.all_gather(parts, g.contiguous(), group=tp)
            g = torch.cat(parts, spec_of[k].index("model")) / TP_RANKS
        if rank == 0:
            w = want[k].float()
            g = g.float().cpu()
            rel[k] = float((g - w).norm() / w.norm().clamp_min(1e-30))
    return rel


def tp_worker(rank, port, out_path):
    """One rank of the TP phase (``chip_smoke.py --tp-rank R PORT OUT``):
    joins the gloo group, checks that gloo carries card tensors, then
    ``hvd.init()`` takes the group and builds the model mesh
    (HOROVOD_MODEL_PARALLEL=2; programs eager, HOROVOD_STEP_PROGRAM=0: a
    gloo collective cannot be captured). Rank 0 also runs the unsharded
    model for the comparisons and writes the results to ``out_path``."""
    import torch.distributed as dist
    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    os.environ.update(HOROVOD_MODEL_PARALLEL=str(TP_RANKS),
                      HOROVOD_STEP_PROGRAM="0", HOROVOD_PROFILER_DISABLE="1")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=TP_RANKS)
    check(_gloo_carries_cuda(dist, card),
          "gloo does not carry card tensors for all_reduce, all_gather "
          "and broadcast: the TP phase cannot run on one card")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serve.engine import ServeEngine
    hvd.init(device=card)
    mesh = hvd.model_mesh()
    tp = mesh.get_group("model")
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    full = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = tfm.param_specs(cfg)
    label = "gloo through the host, 2 ranks on one card: not a TP speed " \
            "figure"
    res = {"gloo_cuda": True}

    # ---- serving: the unsharded engine on rank 0, then the TP engine,
    # each free-running and teacher-forced on the unsharded streams
    on_card = to_card(full, card)  # the TP engine cuts its shard
    streams = [None]
    if rank == 0:
        ref = ServeEngine(on_card, cfg, page_size=PAGE_SIZE, device=card)
        streams[0], _, _ = _tp_greedy(ref)
        ref_rows, _ = _tp_teacher_forced(ref, streams[0])
        del ref
        torch.cuda.empty_cache()
    dist.broadcast_object_list(streams, src=0)
    eng = ServeEngine(on_card, cfg, mesh=mesh, tp_axis="model",
                      page_size=PAGE_SIZE, device=card)
    h_kv = eng._k_pool.shape[3]
    zero_launches(fa)
    rows, prefill_ms = _tp_teacher_forced(eng, streams[0])
    tokens, wall, steps = _tp_greedy(eng)
    torch.cuda.synchronize()
    serve_launches = read_launches(fa)
    del eng
    # the same requests in f32 activations, where the TP tokens must be
    # those of the unsharded engine
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    if rank == 0:
        ref32, _, _ = _tp_greedy(ServeEngine(
            on_card, cfg32, page_size=PAGE_SIZE, device=card))
    tokens32, _, _ = _tp_greedy(ServeEngine(
        on_card, cfg32, mesh=mesh, tp_axis="model", page_size=PAGE_SIZE,
        device=card))
    del on_card
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tp serve rank {rank} ({label}): prefill 8 x 512 "
          f"{prefill_ms:.1f} ms; {steps} scheduler steps in "
          f"{wall * 1e3:.1f} ms ({wall * 1e3 / steps:.1f} ms a step); "
          f"KV pool H_kv {h_kv}; launches {serve_launches}", flush=True)
    checks = [(h_kv == FLAGSHIP["n_kv_heads"] // TP_RANKS,
               f"rank {rank}: the KV pool holds {h_kv} kv heads"),
              (serve_launches["flash_fwd_wgmma"] == 2 * cfg.n_layers
               and sum(serve_launches.values()) == 2 * cfg.n_layers,
               f"rank {rank} tp_serve launches {serve_launches}: "
               f"{2 * cfg.n_layers} flash_fwd on the tensor cores expected")]
    if rank == 0:
        checks += _tp_serve_checks(rows, ref_rows, tokens, streams[0])
        same = [a == b for a, b in zip(tokens32, ref32)]
        print(f"tp serve f32 vs unsharded f32: {sum(same)} of "
              f"{len(same)} streams of {NEW_TOKENS} tokens identical",
              flush=True)
        checks.append((all(same), "tp f32 tokens differ from the "
                                  "unsharded f32 engine's"))
        res.update(prefill_ms=prefill_ms, decode_step_ms=wall * 1e3 / steps,
                   logits_max_abs=float(np.abs(rows - ref_rows).max()))
        del rows, ref_rows

    # ---- training: the unsharded step on rank 0, then the TP steps
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (TP_BATCH, TRAIN_SEQ))).to(card)
    targets = torch.roll(batch, -1, dims=1)
    ref_grads = ref32 = None
    if rank == 0:
        ref = tfm.TransformerLM(cfg, to_card(full, card), device=card)
        loss = ref.loss(batch, targets)
        loss.backward()
        ref_loss = loss.item()
        ref_grads = {k: v.grad.float().cpu()
                     for k, v in tfm._named_leaves(ref.params)}
        del ref, loss
        torch.cuda.empty_cache()
    shard = to_card(tfm.slice_param_shards(full, specs, mesh), card)
    dist.barrier()
    lm = tfm.TransformerLM(cfg, shard, device=card,
                           axes=tfm.ShardAxes(tp=tp))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), **ADAMW),
        named_parameters=lm.named_parameters(),
        model_keys=tfm.model_parallel_keys(cfg))
    zero_launches(fa)
    losses, step_ms = [], []
    for i in range(1 + TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = lm.loss(batch, targets)
        loss.backward()
        opt.synchronize()
        if i == 0:
            grads = {k: v.grad for k, v in tfm._named_leaves(lm.params)}
        opt.step(synchronize=False)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            rel = _tp_grad_rel(dist, tfm, grads, specs, tp, rank, ref_grads)
            del grads
    torch.cuda.synchronize()
    train_launches = read_launches(fa)
    del lm, opt
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the f32 leg: the same step in f32 activations (the CUDA-core
    # loop's exact arithmetic, off the counted path), its gathered
    # gradients against the unsharded f32 model's
    if rank == 0:
        ref = tfm.TransformerLM(cfg32, to_card(full, card), device=card)
        loss = ref.loss(batch, targets)
        loss.backward()
        ref32_loss = loss.item()
        ref32 = {k: v.grad.cpu() for k, v in tfm._named_leaves(ref.params)}
        del ref, loss
        torch.cuda.empty_cache()
    dist.barrier()
    lm = tfm.TransformerLM(cfg32, to_card(tfm.slice_param_shards(
        full, specs, mesh), card), device=card, axes=tfm.ShardAxes(tp=tp))
    del full
    # the exchange as the bf16 step's (a replicated leaf's gradients
    # summed over the group make tp times the unsharded one)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(lm.parameters(), lr=0.0),
        named_parameters=lm.named_parameters(),
        model_keys=tfm.model_parallel_keys(cfg))
    loss32 = lm.loss(batch, targets)
    loss32.backward()
    opt.synchronize()
    rel32 = _tp_grad_rel(dist, tfm, {k: v.grad for k, v in
                                     tfm._named_leaves(lm.params)},
                         specs, tp, rank, ref32)
    loss32 = loss32.item()
    del lm, opt
    want_n = (1 + TP_STEPS) * cfg.n_layers
    check(all(train_launches[k] == want_n for k in (
        "flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"))
        and sum(train_launches.values()) == 3 * want_n,
        f"rank {rank} tp_train launches {train_launches}: {want_n} of each "
        "static kernel on the tensor cores expected")
    print(f"tp train rank {rank} ({label}): B {TP_BATCH} x {TRAIN_SEQ}, "
          f"steps {' '.join(f'{t:.1f}' for t in step_ms)} ms, losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; launches "
          f"{train_launches}", flush=True)
    for ok, msg in checks:
        check(ok, msg)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"tp train: losses not finite or not falling: {losses}")
    if rank == 0:
        worst = max(rel, key=rel.get)
        print(f"tp train vs unsharded: loss {losses[0]:.6f} vs "
              f"{ref_loss:.6f} (|d| {abs(losses[0] - ref_loss):.3g}, tol "
              f"{TRAIN_LOSS_ATOL:g}); gathered gradients relative L2 worst "
              f"{rel[worst]:.4g} at {worst} (tol {TRAIN_GRAD_REL:g}), median "
              f"{float(np.median(list(rel.values()))):.4g} over {len(rel)} "
              "leaves", flush=True)
        worst32 = max(rel32, key=rel32.get)
        print(f"tp train f32 vs unsharded f32: loss {loss32:.6f} vs "
              f"{ref32_loss:.6f} (|d| {abs(loss32 - ref32_loss):.3g}); "
              f"gathered gradients relative L2 worst {rel32[worst32]:.4g} "
              f"at {worst32} (tol {TP_F32_GRAD_REL:g}), median "
              f"{float(np.median(list(rel32.values()))):.4g} over "
              f"{len(rel32)} leaves", flush=True)
        check(abs(losses[0] - ref_loss) <= TRAIN_LOSS_ATOL,
              "tp loss differs from the unsharded model's")
        check(rel[worst] <= TRAIN_GRAD_REL,
              "tp gradients differ from the unsharded model's")
        check(rel32[worst32] <= TP_F32_GRAD_REL,
              "tp f32 gradients differ from the unsharded f32 model's")
        res.update(launches={"tp_serve": serve_launches,
                             "tp_train": train_launches},
                   step_ms=step_ms, losses=losses, ref_loss=ref_loss,
                   grad_rel_worst=rel[worst],
                   f32_grad_rel_worst=rel32[worst32])
        with open(out_path, "w") as f:
            json.dump(res, f)
    hvd.shutdown()
    dist.destroy_process_group()


def phase_tp(where):
    """Tensor parallelism at full width, two ranks on this card
    (:func:`tp_worker`, main paths tp_serve and tp_train): the TP
    engine against the unsharded one (:func:`_tp_serve_checks`: logits
    within LOGITS_ATOL teacher-forced, argmax and free-running tokens
    equal but at near-ties of at most TP_NEAR_TIE; in f32 every token
    equal); each rank's KV pool holds H_kv 2; the TP
    step's loss lies within TRAIN_LOSS_ATOL of the unsharded model's and
    every gathered gradient within TRAIN_GRAD_REL; the loss falls over
    TP_STEPS AdamW steps; every flash launch (H 8 / H_kv 2) takes the
    tensor-core route. Returns ({kernel: launches} of tp_serve, of
    tp_train), rank 0's."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(), "tp.json")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--tp-rank", str(r), str(port), out])
             for r in range(TP_RANKS)]
    try:
        codes = [p.wait(timeout=TP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(codes == [0] * TP_RANKS, f"tp ranks exited with {codes}")
    with open(out) as f:
        res = json.load(f)
    print(f"tp phase [{where}]: 2 ranks over gloo on one card, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return res["launches"]["tp_serve"], res["launches"]["tp_train"]


def moe_stats(tfm, moe, metrics, params, tokens, cfg, full_capacity):
    """One evaluation of the model on ``tokens`` whose MoE layers run
    with ``with_stats`` (the other layers as the model runs them), each
    layer's counts recorded in the hvd_moe_* families
    (``metrics.record_moe_step``). Returns (routed, dropped) summed over
    the MoE layers."""
    routed = dropped = 0.0
    with torch.no_grad():
        x = tfm.embed_tokens(params, tokens, cfg)
        for p in params["layers"]:
            x, _, _ = tfm._attention_block_kv(p, x, cfg)
            if "moe" not in p:
                x, _ = tfm._mlp_block(p, x, cfg)
                continue
            h = tfm._rmsnorm(x, p["ln2"]).to(cfg.dtype)
            y, _, st = moe.moe_layer(p["moe"], h, cfg.moe_cfg,
                                     with_stats=True,
                                     full_capacity=full_capacity)
            x = x + y.to(cfg.dtype)
            r, d = st["routed_tokens"].item(), st["dropped_tokens"].item()
            metrics.record_moe_step(r, d, st["load_balance_loss"].item(),
                                    st["chunks"])
            routed, dropped = routed + r, dropped + d
    return routed, dropped


def full_capacity_logits(tfm, params, tokens, cfg):
    """The model's f32 logits with its MoE layers at full capacity (the
    serving mode)."""
    with torch.no_grad():
        x = tfm.embed_tokens(params, tokens, cfg)
        for p in params["layers"]:
            x, _, _ = tfm._attention_block_kv(p, x, cfg)
            x, _ = tfm._mlp_block(p, x, cfg, moe_full_capacity=True)
        return tfm._head(params, x, cfg)


def router_probs(tfm, moe, params, tokens, cfg, layer):
    """The router probabilities (t, E) of MoE layer ``layer`` (the model
    run up to it) on the host, and each position's k experts (sorted)."""
    with torch.no_grad():
        x = tfm.embed_tokens(params, tokens, cfg)
        for p in params["layers"][:layer]:
            x, _ = tfm._one_layer(p, x, cfg, tfm.ShardAxes())
        p = params["layers"][layer]
        x, _, _ = tfm._attention_block_kv(p, x, cfg)
        h = tfm._rmsnorm(x, p["ln2"]).to(cfg.dtype)
        probs = moe._router(h.reshape(-1, cfg.d_model),
                            p["moe"]["w_router"])
        picks = moe._top_k(probs, cfg.moe_top_k)[1]
        return probs.cpu(), torch.sort(picks, dim=-1).values.cpu()


def phase_moe_parity(tfm, moe, card, init):
    """The MoE layer at full width (d 2048, ff 8192, E 8, top-2, 4 x 4096
    tokens, f32) on the card: its routing tables rebuilt as dense
    tensors equal ``_top_k_dispatch``'s exactly, and ``moe_layer``
    against ``moe_layer_reference`` (the dense einsums): the same aux and
    counts, outputs within MOE_LAYER_REL of the largest; both timed.
    Then flagship-moe cut to 2 layers (the first two of ``init``, a
    host tree: layer 1 MoE), B 1 x MOE_PARITY_SEQ, dense attention and
    full capacity, on the card against the same weights on the CPU:
    router probabilities within MOE_PROB_ATOL, logits within LOGITS_ATOL
    wherever both pick the same experts (all but MOE_FLIPS positions)."""
    cfg = moe.MoEConfig(d_model=FLAGSHIP["d_model"], d_ff=FLAGSHIP["d_ff"],
                        num_experts=MOE_MODEL["moe_num_experts"],
                        top_k=MOE_MODEL["moe_top_k"], dtype=torch.float32)
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(4), card)
    # a router leaning on expert 0, so that its queue overflows and the
    # drop path runs (random rows alone spread over the experts evenly)
    params["w_router"][:, 0] *= 4
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, device=card,
                    generator=torch.Generator(device=card).manual_seed(5))
    t = TRAIN_BATCH * TRAIN_SEQ
    cap = moe.capacity(t, cfg)
    probs = moe._router(x.reshape(t, -1), params["w_router"])
    dense = moe._top_k_dispatch(probs, cfg.top_k, cap)
    tables = moe.routing_to_dense(moe._route(probs, cfg.top_k, cap), cap)
    same = [torch.equal(a, b) for a, b in zip(tables, dense)]
    del dense, tables
    torch.cuda.empty_cache()
    y, aux, st = moe.moe_layer(params, x, cfg, with_stats=True)
    y_ref, aux_ref, st_ref = moe.moe_layer_reference(params, x, cfg,
                                                     with_stats=True)
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    counts = [(st[k].item(), st_ref[k].item())
              for k in ("routed_tokens", "dropped_tokens")]
    ms = time_ms(lambda: moe.moe_layer(params, x, cfg), 3)
    plain_ms = time_ms(lambda: moe.moe_layer_reference(params, x, cfg), 2)
    print(f"moe parity layer (d {cfg.d_model}, ff {cfg.d_ff}, E "
          f"{cfg.num_experts}, top-{cfg.top_k}, {t} tokens, capacity {cap}, "
          f"f32): tables equal dispatch/combine {same}; routed/dropped "
          f"{counts}; aux {aux.item():.6f} vs {aux_ref.item():.6f}; "
          f"max|dy| {err:.3g} of max|y| {scale:.3g} (tol "
          f"{MOE_LAYER_REL * scale:.3g}); forward {ms:.2f} ms, dense plain "
          f"version {plain_ms:.2f} ms", flush=True)
    check(all(same), "MoE routing tables differ from the dense dispatch")
    check(all(a == b for a, b in counts) and aux.item() == aux_ref.item(),
          "MoE counts or aux differ from the dense plain version")
    check(counts[1][0] > 0, "the parity layer dropped nothing")
    check(err <= MOE_LAYER_REL * scale,
          "MoE index form disagrees with the dense plain version")
    del params, x, probs, y, y_ref
    torch.cuda.empty_cache()

    kw = dict(MOE_MODEL, n_layers=2, moe_layers=(1,))
    tcfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="dense",
                                 **kw)
    host = dict(init, layers=init["layers"][:2])
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (1, MOE_PARITY_SEQ)))
    with torch.no_grad():
        want = full_capacity_logits(tfm, host, tokens, tcfg)
        probs, picks = router_probs(tfm, moe, host, tokens, tcfg, 1)
    params = to_card(host, card)
    with torch.no_grad():
        got = full_capacity_logits(tfm, params, tokens.to(card), tcfg).cpu()
    card_probs, card_picks = router_probs(tfm, moe, params, tokens.to(card),
                                          tcfg, 1)
    dp = float((probs - card_probs).abs().max())
    same = (picks == card_picks).all(-1).view(tokens.shape)
    err = (got - want).abs().amax(-1)
    diff = float(err[same].max())
    worst_flip = float(err[~same].max()) if (~same).any() else 0.0
    print(f"moe parity flagship-moe 2 layers (layer 1 MoE, full capacity, "
          f"dense attention) B 1 x {MOE_PARITY_SEQ}, card vs CPU: router "
          f"probabilities max|d| {dp:.3g} (tol {MOE_PROB_ATOL:g}); "
          f"{int((~same).sum())} positions picked other experts (at most "
          f"{MOE_FLIPS}; their max|d logits| {worst_flip:.4g}); max|d "
          f"logits| {diff:.4g} (tol {LOGITS_ATOL:g}) over the "
          f"{int(same.sum())} others; argmax agreement "
          f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.3f}",
          flush=True)
    check(torch.isfinite(got).all() and got.shape == want.shape,
          "flagship-moe logits shape or finiteness")
    check(dp <= MOE_PROB_ATOL, "flagship-moe router: card and CPU disagree")
    check(int((~same).sum()) <= MOE_FLIPS,
          f"{int((~same).sum())} of {MOE_PARITY_SEQ} positions routed apart")
    check(diff <= LOGITS_ATOL, "flagship-moe logits: card and CPU disagree")
    del params
    torch.cuda.empty_cache()


def phase_moe_train(hvd, fa, tfm, moe, metrics, card, where, init):
    """Main path 7: flagship-moe at 4 x 4096 through
    :func:`phase_compiled_train` (3 eager steps, then 3 compiled steps
    and 4 replays, bitwise against eager, expert keys on the exchange);
    then one evaluation of the trained model on the batch with the MoE
    layers' counts recorded: the hvd_moe_* counters must give
    ``dropped == t * k * moe_layers - routed``. Returns {kernel:
    launches} of the compiled steps."""
    launches, params, tokens, _ = phase_compiled_train(
        hvd, fa, tfm, card, where, model=MOE_MODEL, label="moe train",
        expert_keys=MOE_EXPERT_KEYS, init=init)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **MOE_MODEL)
    r0 = metrics.MOE_ROUTED_TOKENS.value()
    d0 = metrics.MOE_DROPPED_TOKENS.value()
    routed, dropped = moe_stats(tfm, moe, metrics, params, tokens, cfg,
                                False)
    got_r = metrics.MOE_ROUTED_TOKENS.value() - r0
    got_d = metrics.MOE_DROPPED_TOKENS.value() - d0
    assigned = TRAIN_BATCH * TRAIN_SEQ * cfg.moe_top_k * len(cfg.moe_layers)
    print(f"moe train routing after the steps: {got_r:.0f} routed, "
          f"{got_d:.0f} dropped of {assigned} assignments "
          f"({got_d / assigned:.4f}); load-balance loss "
          f"{metrics.MOE_LOAD_BALANCE_LOSS.value():.4f} (last layer)",
          flush=True)
    check((got_r, got_d) == (routed, dropped) and got_d == assigned - got_r,
          f"hvd_moe counters: routed {got_r}, dropped {got_d} of {assigned}")
    del params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_moe_serve(fa, serve, metrics, tfm, moe, card, where, init):
    """Main path 8: the serving workload on flagship-moe through the
    eager engine and the graph engine (:func:`serve_both_engines`), MoE
    layers at full capacity: tokens identical, steady decode hit rate
    1.0, no fallback; then the prompts' MoE counts at full capacity:
    nothing dropped. Returns {kernel: launches} of both timed rounds."""
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **MOE_MODEL)
    lm = tfm.TransformerLM(cfg, to_card(init, card), device=card)
    res = serve_both_engines(fa, serve, metrics, lm, card, where,
                             "moe serve")
    graphs = res["graphs"]
    check(graphs["steady_hit_rate"] == 1.0,
          f"moe serve: steady decode hit rate {graphs['steady_hit_rate']}")
    d0 = metrics.MOE_DROPPED_TOKENS.value()
    tokens = torch.tensor(prompts(cfg.vocab_size), device=card)
    routed, dropped = moe_stats(tfm, moe, metrics, lm.params, tokens, cfg,
                                True)
    print(f"moe serve at full capacity: {routed:.0f} routed, {dropped:.0f} "
          f"dropped over the prompts' {len(cfg.moe_layers)} MoE layers",
          flush=True)
    check(dropped == 0 and metrics.MOE_DROPPED_TOKENS.value() == d0
          and routed == tokens.numel() * cfg.moe_top_k * len(cfg.moe_layers),
          f"full capacity dropped {dropped} of {routed + dropped}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return {k: res["eager"]["launches"][k] + graphs["launches"][k]
            for k in graphs["launches"]}


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
    moe = _bench_line(["horovod_tpu_torch.bench.transformer", "--moe",
                       "--expert-parallel", "1"], env, 300)
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
    for row in (moe["moe"], res["moe"]):
        check(row["tokens_per_sec_per_chip"] > 0 and row["fallback_steps"]
              == 0 and row["step_program_cache_hit_rate"] == 1.0
              and row["expert_parallel"] == 1,
              f"bench moe row {row}")
    check(moe["metric"] == "moe_tokens_per_sec_per_chip",
          f"bench moe line {moe}")
    check("divisible by 8" in res["mesh3d"].get("skipped", ""),
          f"bench mesh3d row {res['mesh3d']}: one card cannot hold the "
          "2x2x2 mesh")
    # the phase trace's rows (bench.py's): filled, none skipped
    flight = res["flight_step_phase_breakdown"]
    check(isinstance(flight, dict) and flight["compute_ms"] > 0
          and 0 <= res["flight_overhead_frac"] < TRACE_OVERHEAD_MAX
          and 0 <= res["trace_overhead_frac"] < TRACE_OVERHEAD_MAX
          and res["control_plane"] == {
              "skipped": "not ported: ROADMAP item 10"},
          f"bench flight rows {flight}, {res['flight_overhead_frac']}, "
          f"{res['trace_overhead_frac']}, {res['control_plane']}")
    phases, ab = compiled["step_phase_breakdown"], compiled["overlap_ab"]
    micro = compiled["overlap_microbench"]
    check(isinstance(phases, dict) and phases["forward"] > 0
          and phases["backward"] > 0 and phases["optimizer"] > 0
          and isinstance(compiled["wire_stage_ms"], dict)
          and isinstance(compiled["exchange_hidden_frac"], float)
          and ab["step_ms_base"] > 0 and ab["step_ms_tuned"] > 0
          and micro["step_ms_base"] > 0 and micro["step_ms_tuned"] > 0
          and 0 <= compiled["trace_overhead_frac"] < TRACE_OVERHEAD_MAX,
          f"bench compiled trace rows {phases}, {ab}, {micro}")
    for row in (moe["moe"], res["moe"]):
        check(row["alltoall_ms_per_step"] is None
              and row["alltoall_hidden_frac"] is None
              and row["step_phase_breakdown"]["expert"] > 0,
              f"bench moe trace rows {row}")
    print(f"bench trace rows [{where}]: step_phase_breakdown {phases}; "
          f"wire_stage_ms {compiled['wire_stage_ms']}; exchange_hidden_frac "
          f"{compiled['exchange_hidden_frac']}; overlap_ab {ab}; "
          f"overlap_microbench {micro}; flight_step_phase_breakdown "
          f"{flight}; flight_overhead_frac {res['flight_overhead_frac']}; "
          f"trace_overhead_frac {res['trace_overhead_frac']}; moe "
          f"step_phase_breakdown {moe['moe']['step_phase_breakdown']}",
          flush=True)
    zero = res["zero_profile"]
    check("skipped" not in zero and zero["dcn_bytes_saved_frac"] is None
          and zero["dcn_loss_delta"] == 0.0
          and zero["zero_memory"]["params_stripe_bytes"]
          == zero["zero_memory"]["params_full_bytes"] > 0,
          f"bench zero_profile row {zero}")
    print(f"bench [{where}]: resnet smoke {res['value']} img/s (MFU "
          f"{res['mfu_pct']}%, multiply-adds), compiled "
          f"{compiled['img_sec_per_chip']} img/s (python overhead "
          f"{compiled['python_overhead_ms']} ms a step); serve row "
          f"{srv['tokens_per_sec']} tokens/s, token latency p50/p99 "
          f"{srv['token_latency_p50_ms']}/{srv['token_latency_p99_ms']} ms; "
          f"transformer {tfm['value']} tokens/s (MFU {tfm['mfu_pct']}%); "
          f"moe {moe['value']} tokens/s (drop fraction "
          f"{moe['moe']['drop_fraction']}, resnet's row "
          f"{res['moe']['tokens_per_sec_per_chip']}); zero_profile "
          f"{json.dumps(zero)}", flush=True)


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
    from horovod_tpu_torch.models import moe
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
    phase_ulysses_kernels(fa, card, gen, {"flash_fwd": entry, **bwd_entries})

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
    train_launches, _ = phase_train(hvd, fa, tfm, card, where)
    t0 = time.perf_counter()
    compiled_train_launches, params, _, stage0 = phase_compiled_train(
        hvd, fa, tfm, card, where)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"compiled train phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    trace_launches = phase_trace(hvd, fa, tfm, serve, metrics, card, where,
                                 params)
    del params
    print(f"trace phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    zero_launches_by_stage = phase_zero_train(hvd, fa, tfm, metrics, card,
                                              where, stage0)
    del stage0
    gc.collect()
    print(f"zero train phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    tp_serve_launches, tp_train_launches = phase_tp(where)
    # flagship-moe's weights, drawn once on the host (seed 0) for every
    # MoE phase
    t0 = time.perf_counter()
    moe_cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **MOE_MODEL)
    moe_init = tfm.init_params(moe_cfg, torch.Generator().manual_seed(0),
                               "cpu")
    print(f"flagship-moe: {sum(t.numel() for t in tfm._leaves(moe_init)) / 1e6:.1f}"
          f" M parameters drawn in {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_moe_parity(tfm, moe, card, moe_init)
    print(f"moe parity phase: {time.perf_counter() - t0:.1f} s", flush=True)
    moe_train_launches = phase_moe_train(hvd, fa, tfm, moe, metrics, card,
                                         where, moe_init)
    print(f"moe train phase: {time.perf_counter() - t0:.1f} s", flush=True)
    moe_serve_launches = phase_moe_serve(fa, serve, metrics, tfm, moe, card,
                                         where, moe_init)
    del moe_init
    print(f"moe phases: {time.perf_counter() - t0:.1f} s", flush=True)
    phase_sp_parity(tfm, RingAxis, card)
    sp_launches, ring_step = phase_train(hvd, fa, tfm, card, where,
                                         RingAxis.local(SP_RING))
    ulysses_launches, ulysses_step = phase_train(
        hvd, fa, tfm, card, where, RingAxis.local(SP_RING), "ulysses")
    print(f"sp train 2 x 8192 [{where}]: Ulysses step "
          f"{ulysses_step['step_ms']:.1f} ms ({ulysses_step['tok_s']:.1f} "
          f"tokens/s, peak {ulysses_step['peak'] / 2 ** 30:.2f} GiB) beside "
          f"the ring's {ring_step['step_ms']:.1f} ms "
          f"({ring_step['tok_s']:.1f} tokens/s, peak "
          f"{ring_step['peak'] / 2 ** 30:.2f} GiB)", flush=True)
    t0 = time.perf_counter()
    static = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")
    band = ("flash_band_fwd_wgmma", "flash_band_dq_wgmma",
            "flash_band_dkv_wgmma")
    n_layers = FLAGSHIP["n_layers"]
    compiled_sp = {}
    for sp_impl in ("ring", "ulysses"):
        per_replay = dict.fromkeys(static, SP_RING * n_layers)
        if sp_impl == "ring":
            per_replay.update(dict.fromkeys(
                band, len(SP_BAND_OFFSETS) * n_layers))
        compiled_sp[sp_impl], params, _, _ = phase_compiled_train(
            hvd, fa, tfm, card, where,
            model=dict(SP_MODEL, sp_impl=sp_impl),
            label=f"compiled sp {sp_impl}", shape=(SP_BATCH, SP_SEQ),
            axes=tfm.ShardAxes(sp=RingAxis.local(SP_RING)),
            per_replay=per_replay)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"compiled sp phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    pp_gpipe, pp_1f1b = phase_pipeline(fa, tfm, card, where)
    print(f"pipeline phase: {time.perf_counter() - t0:.1f} s", flush=True)
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
             "compiled_train": compiled_train_launches,
             "zero_train": zero_launches_by_stage,
             "moe_train": moe_train_launches,
             "moe_serve": moe_serve_launches,
             "tp_serve": tp_serve_launches, "tp_train": tp_train_launches,
             "ulysses_train": ulysses_launches,
             "sp_compiled": compiled_sp["ring"],
             "ulysses_compiled": compiled_sp["ulysses"],
             "pp_gpipe": pp_gpipe, "pp_1f1b": pp_1f1b,
             "trace": trace_launches}
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
    if sys.argv[1:2] == ["--tp-rank"]:
        tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
