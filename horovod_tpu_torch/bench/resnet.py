"""ResNet-50 synthetic training benchmark: images/sec per chip.

Counterpart of bench.py's protocol core, on one card per rank:

    python -m horovod_tpu_torch.bench.resnet [--device cpu]

ResNet v1.5 (the space-to-depth stem) at 224x224 in bf16 with f32
parameters, ``channels_last`` on a card, trained on synthetic images
with SGD(0.01) under ``DistributedOptimizer``; batch-norm statistics stay
per replica and are never reduced, as in Horovod. The protocol is the
reference's (its examples/tensorflow_synthetic_benchmark.py): a per-chip
batch sweep over BATCH_CANDIDATES (an out-of-memory batch is recorded as
None and skipped; the smallest batch within 2% of the best wins), two
untimed warm-up calls, then NUM_ITERS timed calls of BATCHES_PER_ITER
steps each, the loss read on the host after each call (the reference's
synchronous loop); MAD outlier rejection, then more rounds of NUM_ITERS
until 1.96 standard errors of the mean are within CI_TARGET_PCT; and a
block-timed rate over NUM_ITERS calls with one barrier. Where the
reference fuses a call's steps into one program (``lax.scan``), the port
runs them as an eager loop.

``mfu_pct`` keeps the reference's constant, ANALYTIC_TRAIN_FLOPS_PER_IMAGE
= 3 x 4.09e9: 4.09 G is ResNet-50's multiply-add count per forward at
224, so at 2 FLOPs a multiply-add the MFU it reports is half the FLOP
rate's share of the card's peak (``hardware.py``); None where the peak
is unknown (the CPU). ``HOROVOD_BENCH_SMOKE=1`` shrinks the run as the
reference does (batch 8, 64x64 images, 2 x 2 steps); its numbers are not
the protocol's. ``--device cpu`` runs the plain versions, for the tests.

One JSON line carries the reference's keys for what it measures, the
flagship transformer's row (``bench.transformer`` at 4 iterations, on a
card), and ``{"skipped": "not ported: ROADMAP item N"}`` for each profile
whose subsystem the port does not have yet (:data:`NOT_PORTED`: the
eager engine's dispatch and exchange profiles and the control plane,
item 10; the input pipeline, item 14; the guard, item 15).

The eager loop's diagnostics, bench.py's: ``flight_step_phase_breakdown``
(the flight recorder's wire, readback and input time over the timed
loop, a timed call, compute the rest of its wall time) and
``flight_overhead_frac`` (the ring's measured per-event cost times the
events the loop recorded, over its wall time); ``trace_overhead_frac``
and ``step_phase_breakdown`` (the compiled profile's, the latter else
the flight recorder's).

``compiled_step`` is bench.py's compiled hot loop profile at the chosen
batch: the same model and SGD(0.01) through ``compiled_train_step`` (on
a card one CUDA graph a step) at EXCHANGE_BUCKETS buckets, two untimed
calls, then max(NUM_ITERS x BATCHES_PER_ITER, 12) steps paced on the
completion of the step PIPELINE_DEPTH back and never fetching a value:
``python_overhead_ms`` is the median wall time of one ``step()`` call,
beside img/s, MFU and the program cache's counters (of the timed
profile). Then, as bench.py: 4 traced steps (``hvd.trace_steps``) give
``step_phase_breakdown`` and ``wire_stage_ms`` (device ms a step by
phase and by staged tier), ``xla_trace_dir`` and
``exchange_hidden_frac``; ``overlap_ab`` times 8 blocked steps at
EXCHANGE_BUCKETS and at 1 bucket, each side's hidden fraction traced;
``overlap_microbench`` is the comm-bound MLP's A/B (depth 8, width
1024, 32 rows a rank; width 256 in the smoke shrink); and
``trace_overhead_frac`` is the idle tracer's cost over the profile's
loop: a tick a step (a replay runs no host code, so none of the phase
ranges). ``guard_overhead_frac`` stays a skipped row (item 15).
``zero_profile`` is bench.py's ZeRO and DCN-compression profile
(:func:`_zero_profile`). ``serve`` is ``bench.transformer --serve``'s
sub-dict, and ``moe``
``bench.transformer --moe``'s at 4 iterations, on the expert mesh of 4
ranks, or 2, as bench.py picks it, and at ``--expert-parallel 1``
(every expert on each card) when the world is odd, one card included.
``mesh3d`` is ``bench.transformer --mesh3d``'s at 4 iterations where the
world holds a multiple of 8 ranks (the 2x2x2 mesh), else a skipped row
with bench.py's reason.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as config_mod
from .. import diag, hardware, optimizers, runtime
from ..models import ResNet50
from ..ops.step_program import compiled_train_step
from . import transformer as transformer_bench

BASELINE_IMG_SEC_PER_DEVICE = 103.55
# ResNet-50 at 224: 4.09 G multiply-adds per forward; training ~ 3x the
# forward. The reference's constant, kept so that both benches report
# the same quantity (it counts multiply-adds, not FLOPs).
ANALYTIC_TRAIN_FLOPS_PER_IMAGE = 3 * 4.09e9
CI_TARGET_PCT = 3.0
NUM_CLASSES = 1000

# The reference's profiles whose subsystems are not ported, by the
# ROADMAP.md Queue 1 item that brings each: the eager engine and the
# control plane (tree fan-in, graduation, simrank) with the native
# engine (10), the input pipeline (14), the guard (15).
NOT_PORTED = {
    "dispatch": 10, "eager_exchange": 10,
    "input_pipeline": 14, "guard_overhead_frac": 15,
    "control_plane": 10,
}
# bench.py's compiled-step profile parts whose subsystems are not ported.
COMPILED_NOT_PORTED = {"guard_overhead_frac": 15}
# bench.py's tuned bucket count of the bucketed backward/exchange
# overlap (HOROVOD_EXCHANGE_BUCKETS, default 8), A/B'd against 1.
EXCHANGE_BUCKETS = max(
    int(os.environ.get("HOROVOD_EXCHANGE_BUCKETS", "8") or 8), 1)
# The record_function ranges one eager step of a one-bucket
# DistributedOptimizer opens with tracing off (forward, backward, the
# bucket hook's exchange and its synchronize, optimizer): the port's
# share of the idle tracer's cost, where the JAX package's named scopes
# cost nothing at run time.
RANGES_PER_STEP = 5
# Calls the compiled loop runs ahead of the completion it waits for
# (bench.py's HOROVOD_PIPELINE_DEPTH default).
PIPELINE_DEPTH = 2


@dataclasses.dataclass(frozen=True)
class Protocol:
    batch_candidates: tuple = (32, 64, 128, 256, 512)
    num_iters: int = 10
    sweep_iters: int = 2
    batches_per_iter: int = 10
    image_size: int = 224
    max_measure_rounds: int = 4
    transformer_iters: int = 4
    micro_width: int = 1024

    @classmethod
    def from_env(cls):
        """The protocol, or its ``HOROVOD_BENCH_SMOKE=1`` shrink."""
        smoke = os.environ.get("HOROVOD_BENCH_SMOKE", "") not in (
            "", "0", "false")
        if not smoke:
            return cls()
        return cls(batch_candidates=(8,), num_iters=2, sweep_iters=1,
                   batches_per_iter=2, image_size=64, max_measure_rounds=1,
                   transformer_iters=1, micro_width=256)


class _Run:
    """One batch size's training state: the model reset to the master
    weights, a fresh optimizer and synthetic data on the device."""

    def __init__(self, model, master, batch, proto, device):
        model.load_state_dict(master)
        self.model, self.batch, self.proto = model, batch, proto
        self.opt = optimizers.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01),
            named_parameters=model.named_parameters())
        gen = torch.Generator(device=device).manual_seed(1)
        self.images = torch.randn(
            (batch, 3, proto.image_size, proto.image_size), generator=gen,
            device=device, dtype=torch.bfloat16)
        if device.type == "cuda":
            self.images = self.images.contiguous(
                memory_format=torch.channels_last)
        gen.manual_seed(2)
        self.labels = torch.randint(0, NUM_CLASSES, (batch,), generator=gen,
                                    device=device)

    def call(self):
        """BATCHES_PER_ITER train steps; the last loss, not yet read."""
        for _ in range(self.proto.batches_per_iter):
            self.opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(self.model(self.images), self.labels)
            loss.backward()
            self.opt.step()
        return loss.detach()

    def warmup(self):
        for _ in range(2):
            float(self.call())

    def timed(self, iters):
        """img/sec of ``iters`` calls, each timed to its loss on the
        host."""
        imgs = self.batch * self.proto.batches_per_iter
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            float(self.call())
            samples.append(imgs / (time.perf_counter() - t0))
        return samples

    def block_timed(self, iters):
        """img/sec over ``iters`` calls with one barrier at the end."""
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = self.call()
        float(loss)
        return (self.batch * self.proto.batches_per_iter * iters
                / (time.perf_counter() - t0))


def _robust_stats(samples):
    """(mean, 1.96 sigma spread, 1.96 sigma / sqrt(n), rejected) after
    MAD outlier rejection (5-sigma equivalent), as the reference takes
    them: one sample that lost a scheduling quantum must not blow the
    interval up."""
    a = np.asarray(samples, dtype=np.float64)
    med = np.median(a)
    mad = np.median(np.abs(a - med))
    keep = a[np.abs(a - med) <= 5.0 * 1.4826 * mad] if mad > 0 else a
    mean = float(np.mean(keep))
    spread = float(1.96 * np.std(keep))
    sem = spread / max(len(keep), 1) ** 0.5
    return mean, spread, sem, len(a) - len(keep)


def _sweep(model, master, proto, device):
    sweep = {}
    for b in proto.batch_candidates:
        try:
            run = _Run(model, master, b, proto, device)
            run.warmup()
            sweep[str(b)] = round(float(np.mean(run.timed(
                proto.sweep_iters))), 1)
        except torch.OutOfMemoryError:
            sweep[str(b)] = None
            print(f"# batch {b}: skipped (out of memory)", file=sys.stderr)
        finally:
            run = None
            if device.type == "cuda":
                torch.cuda.empty_cache()
        print(f"# sweep batch {b}: {sweep[str(b)]} img/s/chip",
              file=sys.stderr)
    usable = {int(b): v for b, v in sweep.items() if v is not None}
    if not usable:
        return sweep, proto.batch_candidates[0]
    cutoff = 0.98 * max(usable.values())
    return sweep, min(b for b, v in usable.items() if v >= cutoff)


def _skipped(item):
    return {"skipped": f"not ported: ROADMAP item {item}"}


def flight_attribution(flight, phase0, events0, loop_wall, iters):
    """bench.py's ``_flight_attribution``: per-iteration phase breakdown
    and recorder self-cost over a timed loop. The breakdown comes from
    the flight recorder's phase accounting (wire/readback/input seconds
    that accrued during the loop, compute the unattributed remainder of
    its wall time); ``flight_overhead_frac`` is measured, not modeled:
    the per-event cost of a ring append (timed on a throwaway recorder,
    same code path) times the events the loop recorded, over the loop's
    wall time. Acceptance for the always-on default is < 1%."""
    from ..diag import FlightRecorder
    if flight is None or loop_wall <= 0 or iters <= 0:
        return None, 0.0
    p1 = flight.phase_totals()
    wire_s = max(p1["wire_s"] - phase0["wire_s"], 0.0)
    readback_s = max(p1["readback_s"] - phase0["readback_s"], 0.0)
    input_s = max(p1["input_s"] - phase0["input_s"], 0.0)
    compute_s = max(loop_wall - wire_s - readback_s - input_s, 0.0)
    per_iter = 1e3 / iters
    breakdown = {
        "compute_ms": round(compute_s * per_iter, 3),
        "wire_ms": round(wire_s * per_iter, 3),
        "readback_ms": round(readback_s * per_iter, 3),
        "input_ms": round(input_s * per_iter, 3),
    }
    probe = FlightRecorder(capacity=256)
    n_probe = 2000
    t0 = time.perf_counter()
    for _ in range(n_probe):
        probe.record("probe", name="bench.overhead", op="PROBE",
                     nbytes=0, dtype="f32")
    cost_per_event = (time.perf_counter() - t0) / n_probe
    events = max(flight.events_recorded - events0, 0)
    frac = min(events * cost_per_event / loop_wall, 1.0)
    return breakdown, round(frac, 6)


def trace_attribution(loop_wall, iters, ranges=RANGES_PER_STEP):
    """bench.py's ``_trace_attribution``: the fraction of a loop's wall
    time the step tracer costs when tracing is OFF — one
    ``StepTracer.tick`` that returns at its first check — plus, in the
    port, the ``ranges`` idle ``record_function`` phase ranges a step of
    the loop opens. Timed on a throwaway tracer and scaled by the loop's
    iteration count (acceptance: < 1%)."""
    from torch.profiler import record_function

    from ..diag.xla_trace import StepTracer
    if loop_wall <= 0 or iters <= 0:
        return 0.0
    probe = StepTracer(diag_dir=".")
    n_probe = 10000
    t0 = time.perf_counter()
    for _ in range(n_probe):
        probe.tick(owner=trace_attribution)
        for _ in range(ranges):
            with record_function("hvd_forward"):
                pass
    cost_per_step = (time.perf_counter() - t0) / n_probe
    return round(min(cost_per_step * iters / loop_wall, 1.0), 6)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _overlap_microbench(device, buckets, width, trace_n=4):
    """bench.py's ``_overlap_microbench``: a params-heavy,
    compute-light MLP (depth 8, ``width``, 32 rows a rank; exchange
    bytes ~ backward FLOPs) through ``compiled_train_step`` with
    SGD(0.01) at ``buckets=1`` and at the tuned count, each side's
    median step time and its traced exchange time and hidden
    fraction."""
    depth, rows = 8, 32 * runtime.size()
    gen = torch.Generator().manual_seed(11)
    host = [torch.randn(width, width, generator=gen) * 0.05
            for _ in range(depth)]
    x = torch.randn(rows // runtime.size(), width, generator=gen).to(device)
    y = torch.zeros_like(x)
    out = {"buckets": buckets, "depth": depth, "width": width}
    for tag, bk in (("base", 1), ("tuned", buckets)):
        model = torch.nn.Module()
        for i, w in enumerate(host):
            model.register_parameter(
                f"w{i}", torch.nn.Parameter(w.clone().to(device)))

        def loss_fn(x, y, model=model):
            h = x
            for i in range(depth):
                h = torch.tanh(h @ getattr(model, f"w{i}"))
            return torch.mean((h - y) ** 2)

        opt = optimizers.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01),
            named_parameters=model.named_parameters())
        step = compiled_train_step(loss_fn, opt,
                                   name=f"bench.overlap_micro.{tag}",
                                   exchange_buckets=bk)
        for _ in range(2):  # warm-up and capture outside the trace
            step(x, y)
        _sync(device)
        ts = []

        def one_step():
            t0 = time.perf_counter()
            step(x, y)
            _sync(device)
            ts.append(time.perf_counter() - t0)

        summary, _, _ = transformer_bench.trace_window(one_step, trace_n)
        ex = (summary or {}).get("exchange")
        out[f"step_ms_{tag}"] = round(float(np.median(ts)) * 1e3, 3)
        out[f"hidden_frac_{tag}"] = (
            None if not ex else round(ex["hidden_frac"], 4))
        out[f"exchange_ms_{tag}"] = (
            None if not ex else round(ex["exchange_s"] * 1e3, 3))
        del step, opt, model
    return out


def _compiled_step_profile(run, proto, device):
    """bench.py's ``_compiled_step_profile`` at ``run``'s batch: the model,
    data and ``DistributedOptimizer(SGD(0.01))`` of ``run`` (its
    parameters as they are) through ``compiled_train_step``, whose graph
    captures the optimizer's bucket all-reduces."""
    model, images, labels = run.model, run.images, run.labels

    def loss_fn(x, y):
        return F.cross_entropy(model(x), y)

    step = compiled_train_step(loss_fn, run.opt, name="bench.compiled",
                               exchange_buckets=EXCHANGE_BUCKETS)
    for _ in range(2):  # untimed: the first call captures
        loss = step(images, labels)
    float(loss)
    h0, m0 = step.cache_hits, step.cache_misses
    cuda = device.type == "cuda"
    iters = max(proto.num_iters * proto.batches_per_iter, 12)
    py_overheads, rates, pending = [], [], deque()
    t_loop0 = time.perf_counter()
    for _ in range(iters + PIPELINE_DEPTH):
        t0 = time.perf_counter()
        step(images, labels)
        py_overheads.append(time.perf_counter() - t0)
        if cuda:
            done = torch.cuda.Event()
            done.record()
            pending.append(done)
        else:
            pending.append(None)
        if len(pending) > PIPELINE_DEPTH:
            done = pending.popleft()
            if done is not None:
                done.synchronize()
            rates.append(run.batch / (time.perf_counter() - t0))
    if cuda:
        torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t_loop0
    hits = step.cache_hits - h0
    misses = step.cache_misses - m0
    compiled_steps = step.compiled_steps
    mean, spread, _, rejected = _robust_stats(rates)
    peak = hardware.peak_flops_per_chip(config_mod.Config.from_env(), device)
    mfu = ANALYTIC_TRAIN_FLOPS_PER_IMAGE * mean / peak * 100.0 if peak \
        else None
    out = {
        "img_sec_per_chip": round(mean, 2),
        "spread": round(spread, 2),
        "samples": len(rates),
        "outliers_rejected": rejected,
        "mfu_pct": None if mfu is None else round(mfu, 2),
        "python_overhead_ms": round(
            float(np.median(py_overheads)) * 1e3, 3),
        "step_program_cache_hit_rate": round(
            hits / max(hits + misses, 1), 4),
        "step_program_cache_hits": hits,
        "step_program_cache_misses": misses,
        "compiled_steps": compiled_steps,
        "fallback_steps": step.fallback_steps,
        "loop_readback_wait_ms": 0.0,
        "exchange_buckets": len(run.opt.exchange_buckets),
        "steps": iters,
    }
    out.update(_compiled_trace_rows(step, run, proto, device, loss_fn))
    out["trace_overhead_frac"] = trace_attribution(loop_wall, iters,
                                                   ranges=0)
    for key, item in COMPILED_NOT_PORTED.items():
        out[key] = _skipped(item)
    return out


def _compiled_trace_rows(step, run, proto, device, loss_fn):
    """bench.py's trace rows of the compiled profile, after its timed
    loop: the phase breakdown of 4 traced steps, the overlap A/B
    (EXCHANGE_BUCKETS against 1 bucket, 8 blocked steps each) and the
    microbench."""
    images, labels = run.images, run.labels

    def one_step(st=step):
        st(images, labels)
        _sync(device)

    summary, trace_dir, phase_ms = transformer_bench.trace_window(one_step)
    stage_ms = hidden = None
    if summary:
        per = 1e3 / transformer_bench.TRACE_STEPS / max(summary["lanes"], 1)
        stage_ms = {k: round(v * per, 3)
                    for k, v in summary["stages"].items()}
        if summary.get("exchange"):
            hidden = round(summary["exchange"]["hidden_frac"], 4)

    def blocked_ms(st, n=8):
        for _ in range(2):
            one_step(st)
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            one_step(st)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    tuned_ms = blocked_ms(step)
    # the base side re-plans the same optimizer (one set of hooks on the
    # parameters): the tuned step is not called again
    step1 = compiled_train_step(loss_fn, run.opt, name="bench.compiled.b1",
                                exchange_buckets=1)
    base_ms = blocked_ms(step1)
    base, _, _ = transformer_bench.trace_window(lambda: one_step(step1))
    base_ex = (base or {}).get("exchange")
    overlap_ab = {
        "buckets_base": 1,
        "buckets_tuned": EXCHANGE_BUCKETS,
        "step_ms_base": round(base_ms, 3),
        "step_ms_tuned": round(tuned_ms, 3),
        "speedup_pct": round((base_ms - tuned_ms) / base_ms * 100.0, 2),
        "hidden_frac_base": (None if not base_ex
                             else round(base_ex["hidden_frac"], 4)),
        "hidden_frac_tuned": hidden,
    }
    micro = _overlap_microbench(device, EXCHANGE_BUCKETS, proto.micro_width)
    if hidden is None and micro:
        hidden = micro.get("hidden_frac_tuned")
    return {"step_phase_breakdown": phase_ms, "wire_stage_ms": stage_ms,
            "xla_trace_dir": trace_dir, "exchange_hidden_frac": hidden,
            "overlap_ab": overlap_ab, "overlap_microbench": micro}


def _zero_profile(device):
    """bench.py's ``_zero_profile`` at ``n = size()``: a D=256 two-layer
    MLP (seed 7) trained 8 compiled steps at ``zero_stage=2``, without
    and with ``dcn_compression="int8"`` (``dcn_local_size`` n // 2 on an
    even world, else 1), each rank on its 4 rows of the batch. Reports
    ``dcn_bytes_saved_frac``, 1 - wire/raw of the DCN stage's byte
    counters over the compressed run; ``dcn_loss_delta``, the gap
    between the two final losses (this rank's loss, the error-feedback
    convergence claim); and ``zero_memory``, the per-rank bytes of the
    zero3 stripes (parameters, gradients, Adam's state after one step)
    against the replicated sizes, from the real buffers.

    At one rank there is no second stage to stage (local 1 = n), so the
    compressed run moves no DCN bytes and ``dcn_bytes_saved_frac`` is
    None, as the reference's formula gives at n 1; both runs are then
    the same exchange and ``dcn_loss_delta`` is 0."""
    from .. import metrics
    n, r = runtime.size(), runtime.rank()
    d, steps = 256, 8
    rng = np.random.RandomState(7)
    w1 = rng.randn(d, d).astype(np.float32) * 0.05
    w2 = rng.randn(d, 8).astype(np.float32) * 0.05
    x = torch.from_numpy(rng.randn(n * 4, d).astype(np.float32)[
        4 * r:4 * r + 4]).to(device)
    y = torch.from_numpy(rng.randn(n * 4, 8).astype(np.float32)[
        4 * r:4 * r + 4]).to(device)
    local = n // 2 if n >= 2 and n % 2 == 0 else 1

    def mlp():
        # the reference's leaf order: b1, b2, w1, w2
        model = torch.nn.Module()
        for k, v in (("b1", np.zeros(d, np.float32)),
                     ("b2", np.zeros(8, np.float32)), ("w1", w1),
                     ("w2", w2)):
            model.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v.copy()).to(device)))

        def loss(x, y):
            h = torch.tanh(x @ model.w1 + model.b1)
            return ((h @ model.w2 + model.b2 - y) ** 2).mean()
        return model, loss

    def adam(model, **kw):
        capturable = {"capturable": True} if device.type == "cuda" else {}
        return optimizers.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2, **capturable),
            named_parameters=model.named_parameters(), **kw)

    def run(dcn):
        model, loss_fn = mlp()
        step = compiled_train_step(loss_fn, adam(
            model, zero_stage=2, dcn_compression=dcn,
            dcn_local_size=local if dcn else 0),
            name=f"bench.zero2.{dcn or 'raw'}")
        for _ in range(steps):
            loss = step(x, y)
        return float(loss)

    def dcn_bytes(family):
        return family.collect().get('stage="dcn"', 0.0)

    loss_raw = run("")
    wire0 = dcn_bytes(metrics.WIRE_STAGE_BYTES)
    raw0 = dcn_bytes(metrics.WIRE_STAGE_RAW_BYTES)
    loss_c = run("int8")
    wire = dcn_bytes(metrics.WIRE_STAGE_BYTES) - wire0
    raw = dcn_bytes(metrics.WIRE_STAGE_RAW_BYTES) - raw0
    saved = round(1.0 - wire / raw, 4) if raw else None

    model, loss_fn = mlp()
    opt3 = adam(model, zero_stage=3)
    step3 = compiled_train_step(loss_fn, opt3, name="bench.zero3.mem")
    full_params = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    stripe = step3.shard_params()
    stripe_bytes = stripe.numel() * stripe.element_size()
    step3(x, y)
    opt_stripe = sum(t.numel() * t.element_size()
                     for t in opt3.state[stripe].values()
                     if torch.is_tensor(t))
    memory = {
        "world_size": n,
        "params_full_bytes": full_params,
        "params_stripe_bytes": stripe_bytes,
        "grads_stripe_bytes": stripe_bytes,
        "opt_state_stripe_bytes": opt_stripe,
        # params + grads + opt state: the stripes against the replicated
        # layout (replicated state would be this stripe's on every rank)
        "resident_frac_of_replicated": round(
            (2 * stripe_bytes + opt_stripe)
            / max(2 * full_params + opt_stripe * n, 1), 4),
    }
    return {
        "zero_stage": 2,
        "dcn_local_size": local,
        "dcn_bytes_saved_frac": saved,
        "dcn_loss_delta": round(abs(loss_c - loss_raw), 6),
        "loss_uncompressed": round(loss_raw, 6),
        "loss_compressed": round(loss_c, 6),
        "zero_memory": memory,
        "steps": steps,
    }


def _mesh3d_row(device):
    """bench.py's composable-parallelism row: ``bench.transformer
    --mesh3d``'s sub-dict at 4 iterations on the 2x2x2 (data, expert,
    model) mesh, where the world holds a multiple of 8 ranks; else, or
    when it fails, a skipped row saying why, as bench.py records it."""
    if runtime.size() % 8:
        return {"skipped": "needs a device count divisible by 8 and the "
                           "device-resident path for the 2x2x2 (data, "
                           "expert, model) mesh"}
    try:
        return transformer_bench.run_mesh3d_benchmark(
            transformer_bench.parse_args(
                ["--mesh3d", "--iters", "4", "--device", device.type])
        )["mesh3d"]
    except Exception as e:  # noqa: BLE001 - recorded, as bench.py does
        return {"skipped": f"{type(e).__name__}: {e}"}


def run_benchmark(proto, device):
    runtime.init(device=device)
    device = runtime.device()
    cuda = device.type == "cuda"
    model = ResNet50(num_classes=NUM_CLASSES, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0),
                     device=device)
    if cuda:
        model = model.to(memory_format=torch.channels_last)
    optimizers.broadcast_parameters(model.state_dict(), root_rank=0)
    model.train()
    # The master copy lives on the host; every batch size starts from it.
    master = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}

    sweep, best = _sweep(model, master, proto, device)
    run = _Run(model, master, best, proto, device)
    run.warmup()
    samples, rounds = [], 0
    flight = diag.get()
    phase0 = flight.phase_totals() if flight is not None else None
    events0 = flight.events_recorded if flight is not None else 0
    t_loop0 = time.perf_counter()
    while True:
        samples += run.timed(proto.num_iters)
        rounds += 1
        mean, spread, sem, rejected = _robust_stats(samples)
        if sem <= CI_TARGET_PCT / 100.0 * mean \
                or rounds >= proto.max_measure_rounds:
            break
        print(f"# CI {sem / mean * 100:.1f}% > {CI_TARGET_PCT}% after "
              f"{len(samples)} samples; measuring another round",
              file=sys.stderr)
    loop_wall = time.perf_counter() - t_loop0
    flight_phases, flight_overhead = flight_attribution(
        flight, phase0, events0, loop_wall, len(samples))
    ci_pct = sem / mean * 100.0 if mean else 0.0
    block_rate = run.block_timed(proto.num_iters)
    compiled = _compiled_step_profile(run, proto, device)
    print(f"# compiled step: {compiled['img_sec_per_chip']:.1f} img/s/chip "
          f"(eager {mean:.1f}), python overhead "
          f"{compiled['python_overhead_ms']:.3f} ms/step, cache hit rate "
          f"{compiled['step_program_cache_hit_rate']:.2f}, fallbacks "
          f"{compiled['fallback_steps']}", file=sys.stderr)
    peak = hardware.peak_flops_per_chip(config_mod.Config.from_env(), device)
    mfu = ANALYTIC_TRAIN_FLOPS_PER_IMAGE * mean / peak * 100.0 if peak \
        else None
    card = hardware.card_line(device.index or 0) if cuda else None
    print(f"# Img/sec per chip on {card or 'cpu'}: {mean:.1f} +-{spread:.1f} "
          f"(sem-ci {ci_pct:.1f}%, {rejected} outlier(s) rejected, "
          f"{len(samples)} samples) at batch {best}, block-timed "
          f"{block_rate:.1f}; MFU {mfu if mfu is None else round(mfu, 2)}% "
          f"(multiply-adds, the reference's constant)", file=sys.stderr)
    del run, model, master
    if cuda:
        torch.cuda.empty_cache()
        transformer = transformer_bench.run_benchmark(
            transformer_bench.parse_args(
                ["--iters", str(proto.transformer_iters)]))
    else:
        transformer = {"skipped": "runs on a CUDA card: python -m "
                                  "horovod_tpu_torch.bench.transformer"}
    serve = transformer_bench.run_serve_benchmark(
        transformer_bench.parse_args(["--serve", "--device",
                                      device.type]))["serve"]
    world = runtime.size()
    ep = 4 if world % 4 == 0 else 2 if world % 2 == 0 else 1
    moe = transformer_bench.run_moe_benchmark(transformer_bench.parse_args(
        ["--moe", "--iters", "4", "--expert-parallel", str(ep),
         "--device", device.type]))["moe"]
    zero = _zero_profile(runtime.device())
    mesh3d = _mesh3d_row(device)
    result = {
        "metric": "resnet50_img_sec_per_chip",
        "value": round(mean, 2),
        "unit": "img/sec",
        "vs_baseline": round(mean / BASELINE_IMG_SEC_PER_DEVICE, 3),
        "batch_per_chip": best,
        "ci_pct": round(ci_pct, 2),
        "ci_degraded": ci_pct > CI_TARGET_PCT,
        "samples": len(samples),
        "outliers_rejected": rejected,
        "img_sec_block_timed": round(block_rate, 2),
        "mfu_pct": None if mfu is None else round(mfu, 2),
        "sweep": sweep,
        "transformer": transformer,
        "compiled_step": compiled,
        "serve": serve,
        "moe": moe,
        "zero_profile": zero,
        "mesh3d": mesh3d,
        "step_phase_breakdown": compiled.get("step_phase_breakdown")
        or flight_phases,
        "flight_step_phase_breakdown": flight_phases,
        "flight_overhead_frac": flight_overhead,
        "trace_overhead_frac": compiled["trace_overhead_frac"],
        "card": card,
    }
    for key, item in NOT_PORTED.items():
        result[key] = _skipped(item)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the tests)")
    args = ap.parse_args(argv)
    os.environ.setdefault("HOROVOD_PROFILER_DISABLE", "1")
    result = run_benchmark(Protocol.from_env(), args.device)
    runtime.shutdown()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
