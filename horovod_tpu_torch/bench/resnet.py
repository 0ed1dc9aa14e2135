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
whose subsystem the port does not have yet.

``compiled_step`` is bench.py's compiled hot loop profile at the chosen
batch: the same model and SGD(0.01) through ``compiled_train_step`` (on
a card one CUDA graph a step), two untimed calls, then
max(NUM_ITERS x BATCHES_PER_ITER, 12) steps paced on the completion of
the step PIPELINE_DEPTH back and never fetching a value:
``python_overhead_ms`` is the median wall time of one ``step()`` call,
beside img/s, MFU and the program cache's counters. Its phase trace and
``overlap_ab`` parts are skipped rows naming the items that bring them.
``serve`` is ``bench.transformer --serve``'s sub-dict.
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
from .. import hardware, optimizers, runtime
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
# ROADMAP.md Queue 1 item that brings each.
NOT_PORTED = {
    "dispatch": 10, "eager_exchange": 10, "zero_profile": 11,
    "input_pipeline": 14, "flight_step_phase_breakdown": 16,
    "guard_overhead_frac": 15, "trace_overhead_frac": 16, "moe": 7,
    "mesh3d": 6, "control_plane": 16,
}
# bench.py's compiled-step profile parts whose subsystems are not ported:
# the bucket overlap A/B and the step's phase trace.
COMPILED_NOT_PORTED = {
    "overlap_ab": 11, "overlap_microbench": 11, "step_phase_breakdown": 16,
    "wire_stage_ms": 16, "guard_overhead_frac": 15,
    "trace_overhead_frac": 16,
}
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

    @classmethod
    def from_env(cls):
        """The protocol, or its ``HOROVOD_BENCH_SMOKE=1`` shrink."""
        smoke = os.environ.get("HOROVOD_BENCH_SMOKE", "") not in (
            "", "0", "false")
        if not smoke:
            return cls()
        return cls(batch_candidates=(8,), num_iters=2, sweep_iters=1,
                   batches_per_iter=2, image_size=64, max_measure_rounds=1,
                   transformer_iters=1)


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


def _compiled_step_profile(run, proto, device):
    """bench.py's ``_compiled_step_profile`` at ``run``'s batch: the model,
    data and ``DistributedOptimizer(SGD(0.01))`` of ``run`` (its
    parameters as they are) through ``compiled_train_step``, whose graph
    captures the optimizer's bucket all-reduces."""
    model, images, labels = run.model, run.images, run.labels

    def loss_fn(x, y):
        return F.cross_entropy(model(x), y)

    step = compiled_train_step(loss_fn, run.opt, name="bench.compiled")
    for _ in range(2):  # untimed: the first call captures
        loss = step(images, labels)
    float(loss)
    h0, m0 = step.cache_hits, step.cache_misses
    cuda = device.type == "cuda"
    iters = max(proto.num_iters * proto.batches_per_iter, 12)
    py_overheads, rates, pending = [], [], deque()
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
    hits = step.cache_hits - h0
    misses = step.cache_misses - m0
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
        "compiled_steps": step.compiled_steps,
        "fallback_steps": step.fallback_steps,
        "loop_readback_wait_ms": 0.0,
        "exchange_buckets": len(run.opt.exchange_buckets),
        "exchange_hidden_frac": None,
        "steps": iters,
    }
    for key, item in COMPILED_NOT_PORTED.items():
        out[key] = _skipped(item)
    return out


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
