"""The benchmark's arithmetic, on numbers and trace events made by hand:
idle share, exposed exchange, rooflines, percentiles and MFU."""

import json
import math
import random
import types
from pathlib import Path

import numpy as np
import pytest

from yardstick import arith, cell, kineto, peaks, spec

BENCH = Path(__file__).resolve().parents[1]
FLAGSHIP = json.loads((BENCH / "configs" / "flagship.json").read_text())
MOE = json.loads((BENCH / "configs" / "flagship-moe.json").read_text())
H100 = peaks.of("NVIDIA H100 80GB HBM3")


def kernel(name, ts, dur, corr=None, tid=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": {"correlation": corr}}


def host(cat, name, ts, dur, corr=None, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def ctx_of(events, cfg=FLAGSHIP, steps=1, batch=4, seq=4096, **kw):
    win = kineto.window(events)
    base = dict(cfg=cfg, batch=batch, seq=seq, tokens_per_step=batch * seq,
                steps=steps, events=events, window=win, summary=None,
                window_s=(win[1] - win[0]) * 1e-6,
                busy_s=kineto.busy(events, win), peaks=H100,
                peak_bytes=0, program_misses=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def metric(name):
    return spec.load_module(BENCH / "metrics" / f"{name}.py", f"t_{name}")


def test_flagship_counts_match_the_records():
    assert arith.product_params(FLAGSHIP) == 419430400
    assert arith.flops_per_token(FLAGSHIP, 4096) * 16384 == 47828755808256
    # top-2 of 8 experts in 4 of 8 layers, the routers counted
    assert arith.product_params(MOE) == 553713664
    assert arith.product_params(MOE, active=False) == 1359020032


def test_attention_work_by_hand():
    cfg = dict(n_heads=2, n_kv_heads=1, d_model=8, n_layers=3)
    flops, nbytes = arith.attention_work(cfg, batch=1, seq=4)
    pairs = 4 * 5 // 2  # causal (query, key) pairs of one row
    assert flops == 3 * 12 * 4 * pairs * 2  # 12 x D a pair, 2 heads
    q, kv, lse = 1 * 4 * 2 * 4 * 2, 1 * 4 * 1 * 4 * 2, 1 * 2 * 4 * 4
    assert nbytes == 3 * ((2 * q + 2 * kv + lse) + (4 * q + 4 * kv + lse))


def test_idle_share_of_a_window():
    events = [host("user_annotation", "ProfilerStep#1", 0, 400),
              kernel("a", 0, 100), kernel("b", 150, 100),
              dict(kernel("copy", 200, 100, tid=8), cat="gpu_memcpy"),
              host("cpu_op", "aten::mm", 100, 40)]
    ctx = ctx_of(events)
    assert ctx.window == (0.0, 400.0)
    assert ctx.busy_s == pytest.approx(250e-6)
    assert metric("device_idle_pct").read(ctx) == pytest.approx(37.5)
    gaps = kineto.idle_gaps(events, ctx.window)
    assert gaps[0] == ["no host op", pytest.approx(100e-6)]
    assert gaps[1] == ["aten::mm", pytest.approx(50e-6)]


def test_exposed_exchange_by_hand():
    events = [host("user_annotation", "ProfilerStep#1", 0, 1000),
              host("user_annotation", "hvd_backward", 0, 1000),
              host("user_annotation", "hvd_exchange", 500, 10, tid=2),
              host("cuda_runtime", "cudaLaunchKernel", 100, 2, corr=1),
              host("cuda_runtime", "cudaLaunchKernel", 505, 2, corr=2, tid=2),
              kernel("gemm", 100, 500, corr=1),
              kernel("ncclDevKernel_AllReduce", 550, 250, corr=2, tid=9)]
    phases = kineto.phases_by_launch(events)
    assert [p for p, _, _ in phases] == ["backward", "exchange"]
    assert kineto.exposed(phases, "exchange") == pytest.approx(200e-6)
    assert metric("exchange_exposed_ms").read(ctx_of(events)) == \
        pytest.approx(0.2)
    # a replayed graph launches every kernel from one call: no reading
    graph = events + [host("cuda_runtime", "cudaGraphLaunch", 0, 1)]
    assert metric("exchange_exposed_ms").read(ctx_of(graph)) is None


def test_rooflines_by_hand():
    flops, nbytes = arith.attention_work(FLAGSHIP, 4, 4096)
    least = max(flops / 989e12, nbytes / 3.35e12)
    dev = 2 * least  # the kernels take twice their least time
    events = [host("user_annotation", "ProfilerStep#1", 0, 3e6),
              kernel("void tc::flash_fwd_wgmma_kernel", 0, dev * 1e6 / 2),
              kernel("void tc::flash_bwd_dq_wgmma_kernel", 1e6, dev * 1e6 / 2),
              kernel("sm80_xmma_gemm_f32f32_f32f32", 2e6, 1e6)]
    ctx = ctx_of(events)
    assert metric("attn_roofline_pct").read(ctx) == pytest.approx(50.0)
    gemm = arith.gemm_flops(FLAGSHIP, 16384) / 989e12
    assert metric("gemm_roofline_pct").read(ctx) == pytest.approx(100 * gemm)
    # a step's share of the peak over the window's length
    step = arith.flops_per_token(FLAGSHIP, 4096) * 16384 / 989e12
    assert metric("step_mfu_pct").read(ctx) == pytest.approx(100 * step / 3.0)
    # nothing to read: nothing returned, never 0
    none = ctx_of([host("user_annotation", "ProfilerStep#1", 0, 10),
                   kernel("elementwise", 0, 10)])
    assert metric("attn_roofline_pct").read(none) is None
    assert metric("gemm_roofline_pct").read(none) is None


def test_phase_metrics_read_the_program_summary():
    ctx = ctx_of([host("user_annotation", "ProfilerStep#1", 0, 10),
                  kernel("k", 0, 10)], steps=4,
                 summary={"phases": {"forward": 1.2, "backward": 2.4,
                                     "optimizer": 0.08, "exchange": 0.0,
                                     "expert": 0.4}})
    assert metric("forward_ms").read(ctx) == pytest.approx(300.0)
    assert metric("backward_ms").read(ctx) == pytest.approx(600.0)
    assert metric("optimizer_ms").read(ctx) == pytest.approx(20.0)
    assert metric("moe_expert_ms").read(ctx) == pytest.approx(100.0)
    assert metric("exchange_ms").read(ctx) is None


@pytest.mark.parametrize("n", [1, 2, 7, 19, 40])
def test_percentile_is_numpys(n):
    rng = random.Random(n)
    xs = [rng.uniform(900, 1100) for _ in range(n)]
    for q in (50, 90, 95):
        assert arith.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_intervals():
    merged = arith.merge([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert merged == [(0, 3), (5, 9)]
    assert arith.length(merged) == 7
    assert arith.intersection(merged, arith.merge([(2, 6), (8, 20)])) == 3
    assert arith.clip([(0, 3), (5, 9)], 1, 6) == [(1, 3), (5, 6)]


def test_end_to_end_by_hand():
    reports = [
        {"steps": 3, "window_s": 3.0, "tokens_per_step": 16384,
         "kind": "NVIDIA H100 80GB HBM3", "step_ms": [1000.0, 990.0, 1010.0],
         "window_start": 130.0},
        {"steps": 3, "window_s": 3.2, "tokens_per_step": 16384,
         "kind": "NVIDIA H100 80GB HBM3", "step_ms": [1005.0, 995.0, 1000.0],
         "window_start": 131.0}]
    e2e = cell._end_to_end(reports, FLAGSHIP, {"seq": 4096}, t_start=100.0)
    tps = 3 * 16384 / 3.2  # per chip, over the slower rank's window
    assert e2e["tokens_per_s"] == pytest.approx(tps)
    assert e2e["mfu_pct"] == pytest.approx(
        100 * tps * arith.flops_per_token(FLAGSHIP, 4096) / 989e12)
    # the slowest rank's time for each step, then the percentile
    assert e2e["step_ms_p90"] == pytest.approx(
        np.percentile([1005.0, 995.0, 1010.0], 90))
    assert e2e["setup_s"] == pytest.approx(31.0)
    assert not math.isnan(e2e["mfu_pct"])
