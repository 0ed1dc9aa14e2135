"""The port's phase trace (horovod_tpu_torch/diag/xla_trace.py) against
the JAX package's (horovod_tpu/diag/xla_trace.py).

The same seeded inputs go through both: the scope-path rule and the
interval folds directly, and a synthetic capture of the same device
intervals as an XLA trace with its HLO map (the JAX parser) and as a
kineto trace with its launches and ``hvd_`` ranges (the port's parser),
whose summaries must be equal. Then what only the port has: the join
across threads, a replayed graph's phase map, and a traced compiled
step of a small transformer on the CPU, where the top-level host ops
stand in for kernels. The CLI's ``--xla-trace`` merge runs on a port
capture.
"""

import json
import os

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.diag import xla_trace as jax_trace
from horovod_tpu_torch.diag import xla_trace
from horovod_tpu_torch.diag.xla_trace import StepTracer, parse_trace_dir
from horovod_tpu_torch.models import transformer as tfm

LABELS = ("hvd_forward", "hvd_backward", "hvd_exchange", "hvd_optimizer",
          "hvd_guard", "hvd_dispatch", "hvd_expert", "hvd_combine",
          "hvd_prefill", "hvd_decode", "hvd_ici", "hvd_dcn")
SUMMARY_KEYS = ("phases", "stages", "moe", "exchange", "total_s", "events",
                "lanes")


def _paths(seed, n):
    """n scope paths of 0-3 labels each (an empty path: no hvd_ range)."""
    rng = np.random.default_rng(seed)
    return [[LABELS[i] for i in rng.integers(0, len(LABELS),
                                             rng.integers(0, 4))]
            for _ in range(n)]


def _intervals(seed, n):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0, 1000, n)
    return [(float(s), float(s + d))
            for s, d in zip(starts, rng.uniform(0, 80, n))]


@pytest.mark.parametrize("seed", range(4))
def test_scope_path_rule_matches_the_reference(seed):
    for path in _paths(seed, 64):
        op_name = "/".join(["jit(step)"] + path + ["dot_general"])
        scope = "/".join(path)
        assert xla_trace.phase_of_op_name(scope) \
            == jax_trace.phase_of_op_name(op_name)
        assert xla_trace.stage_of_op_name(scope) \
            == jax_trace.stage_of_op_name(op_name)
    assert xla_trace.phase_of_op_name(None) is None
    assert xla_trace.phase_of_op_name(
        "hvd_optimizer/hvd_exchange") == "exchange"


@pytest.mark.parametrize("seed", range(4))
def test_interval_folds_match_the_reference(seed):
    ivs = _intervals(seed, 40)
    merged = xla_trace._merge_intervals(ivs)
    assert merged == jax_trace._merge_intervals(ivs)
    for iv in _intervals(seed + 100, 20):
        assert xla_trace._overlap_us(iv, merged) == pytest.approx(
            jax_trace._overlap_us(iv, merged), abs=0.0)


def _synthetic(seed, n=48):
    """The same device events as ``(xla_events, hlo_map,
    kineto_events)``: event i runs on one of 2 streams for a seeded
    time; its launch sits at host time 1000 i + 500, on the main thread
    or (every third) on autograd's, inside ``hvd_`` ranges (on the main
    thread) for its scope path, and a non-hvd range around them."""
    rng = np.random.default_rng(seed)
    paths = _paths(seed, n)
    xla, hlo, kin = [], {}, []
    for i, path in enumerate(paths):
        ts = float(rng.uniform(0, 5000))
        dur = float(rng.uniform(1, 200))
        stream = int(rng.integers(7, 9))
        op = f"fusion.{i}"
        xla.append({"ph": "X", "name": op, "ts": ts, "dur": dur, "pid": 1,
                    "tid": stream, "args": {"hlo_op": op}})
        hlo[op] = "/".join(["jit(step)"] + path + ["dot_general"])
        kin.append({"ph": "X", "cat": "kernel", "name": f"kernel_{i % 5}",
                    "ts": ts, "dur": dur, "pid": 0, "tid": stream,
                    "args": {"correlation": i + 1}})
        host = 1000.0 * i + 500.0
        kin.append({"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "ts": host, "dur": 3.0,
                    "pid": 42, "tid": 2 if i % 3 == 0 else 1,
                    "args": {"correlation": i + 1}})
        kin.append({"ph": "X", "cat": "user_annotation", "name": "step",
                    "ts": 1000.0 * i, "dur": 999.0, "pid": 42, "tid": 1})
        for depth, label in enumerate(path):
            kin.append({"ph": "X", "cat": "user_annotation", "name": label,
                        "ts": 1000.0 * i + 10 * (depth + 1),
                        "dur": 980.0 - 20 * depth, "pid": 42, "tid": 1})
    return xla, hlo, kin


def _write(dirpath, events, name="rank0.pt.trace.json"):
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, name), "w") as f:
        json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("seed", range(3))
def test_synthetic_capture_parses_as_the_reference(tmp_path, seed):
    xla, hlo, kin = _synthetic(seed)
    _write(str(tmp_path / "xla"), xla, "host.trace.json")
    _write(str(tmp_path / "kineto"), kin)
    want = jax_trace.parse_trace_dir(str(tmp_path / "xla"),
                                     jax_trace.build_op_phase_map(
                                         "\n".join(
                                             f'%{k} = f32[] add(), metadata='
                                             f'{{op_name="{v}"}}'
                                             for k, v in hlo.items())))
    got = parse_trace_dir(str(tmp_path / "kineto"))
    for key in SUMMARY_KEYS:
        if isinstance(want[key], dict):
            assert got[key].keys() == want[key].keys(), key
            for k, v in want[key].items():
                assert got[key][k] == pytest.approx(v, rel=1e-12), (key, k)
        elif want[key] is None:
            assert got[key] is None, key
        else:
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["unmatched"] == got["graph_events"] == 0
    assert sum(sum(by.values()) for by in got["kernels"].values()) \
        == pytest.approx(got["total_s"])


def _node_phase(i, n_nodes):
    return i * 3 // n_nodes


def _node_time(i, n_nodes):
    """Node i's launch: inside the range of phase ``_node_phase``."""
    j = _node_phase(i, n_nodes)
    first = next(k for k in range(n_nodes) if _node_phase(k, n_nodes) == j)
    return 300.0 * j + 50.0 + 5.0 * (i - first)


def _graph_trace(n_nodes, replays, name="k{}".format):
    """A re-capture of program ``p3`` (``n_nodes`` launches with no device
    event: nothing ran, two of them on autograd's thread) and
    ``replays``: [(nodes, key)] graph launches under ``hvd_graph:key``,
    whose kernels all correlate to their ``cudaGraphLaunch``: the first
    ``nodes`` nodes' kernels, or those of the node indices ``nodes``
    lists, node i's kernel named ``name(i)``."""
    phases = ["hvd_forward", "hvd_backward", "hvd_optimizer"]
    ev = [{"ph": "X", "cat": "user_annotation", "name": "hvd_recapture:p3",
           "ts": 0.0, "dur": 1000.0, "pid": 1, "tid": 1}]
    # capture_begin's fills run before the capture opens (one of them
    # lost its device event): neither is a node
    for i, t in enumerate((1.0, 2.0)):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": t, "dur": 0.5,
                   "pid": 1, "tid": 1,
                   "args": {"correlation": 50 + i}})
    ev.append({"ph": "X", "cat": "kernel", "name": "fill", "ts": 3.0,
               "dur": 1.0, "pid": 0, "tid": 13, "args": {"correlation": 50}})
    ev.append({"ph": "X", "cat": "cuda_runtime",
               "name": "cudaStreamBeginCapture", "ts": 5.0, "dur": 1.0,
               "pid": 1, "tid": 1, "args": {"correlation": 60}})
    ev.append({"ph": "X", "cat": "cuda_runtime",
               "name": "cudaStreamEndCapture", "ts": 995.0, "dur": 1.0,
               "pid": 1, "tid": 1, "args": {"correlation": 61}})
    for j, ph in enumerate(phases):
        ev.append({"ph": "X", "cat": "user_annotation", "name": ph,
                   "ts": 300.0 * j + 10, "dur": 280.0, "pid": 1, "tid": 1})
    for i in range(n_nodes):
        t = _node_time(i, n_nodes)
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaMemsetAsync" if i == 1
                   else "cudaLaunchKernel", "ts": t, "dur": 1.0, "pid": 1,
                   "tid": 2 if i in (2, 3) else 1,
                   "args": {"correlation": 100 + i}})
        # a capture's bookkeeping calls are not graph nodes
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaStreamGetCaptureInfo_v2", "ts": t + 1,
                   "dur": 0.5, "pid": 1, "tid": 1,
                   "args": {"correlation": 500 + i}})
    t0 = 2000.0
    for r, (nodes, key) in enumerate(replays):
        corr = 900 + r
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": f"hvd_graph:{key}", "ts": t0, "dur": 50.0,
                   "pid": 1, "tid": 1})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
                   "ts": t0 + 5, "dur": 10.0, "pid": 1, "tid": 1,
                   "args": {"correlation": corr}})
        for i in (range(nodes) if isinstance(nodes, int) else nodes):
            ev.append({"ph": "X", "cat": "gpu_memset" if i == 1 else "kernel",
                       "name": name(i), "ts": t0 + 100 + 10 * i, "dur": 8.0,
                       "pid": 0, "tid": 7, "args": {"correlation": corr}})
        t0 += 1000.0
    return ev


def test_replayed_graph_joins_through_the_phase_map(tmp_path):
    n = 9
    _write(str(tmp_path), _graph_trace(n, [(n, "p3"), (n, "p3")]))
    s = parse_trace_dir(str(tmp_path))
    assert s["op_map"]["p3"][0] == "hvd_forward"
    assert len(s["op_map"]["p3"]) == n
    # node i sits in the phase whose range encloses its launch
    want = {"forward": 0, "backward": 0, "optimizer": 0}
    for i in range(n):
        want[("forward", "backward", "optimizer")[_node_phase(i, n)]] += 1
    for ph, k in want.items():
        assert s["phases"][ph] == pytest.approx(2 * k * 8e-6)
    # the executed fill is eager work outside every range
    assert s["phases"]["other"] == pytest.approx(1e-6)
    assert (s["graph_events"], s["unmatched"]) == (2 * n, 0)
    assert s["kernels"]["k0"] == {"forward": pytest.approx(16e-6)}


def test_unmatched_replays_fall_into_other_and_are_counted(tmp_path):
    n = 6
    # one replay of a map's length, one short by a node, one of a
    # program no window mapped; every kernel has one name, so the names
    # do not tell which node the short replay lost
    _write(str(tmp_path), _graph_trace(n, [(n, "p3"), (n - 1, "p3"),
                                           (n, "p8")], name=lambda i: "k"))
    s = parse_trace_dir(str(tmp_path))
    # the short replay: event i is node i or i+1, placed where both share
    # a phase (nodes 0-1 forward, 2-3 backward, 4-5 optimizer), so 2 of
    # its 5 straddle a boundary; no map places p8's
    assert (s["graph_events"], s["unmatched"]) == (3 * n - 1, 2 + n)
    assert s["graphs"]["p3"] == {"nodes": n, "events": 2 * n - 1,
                                 "unmatched": 2, "lost": 1}
    assert s["graphs"]["p8"] == {"nodes": None, "events": n,
                                 "unmatched": n, "lost": 0}
    # (and the re-capture's executed fill: eager, outside every range)
    assert s["phases"]["other"] == pytest.approx((2 + n) * 8e-6 + 1e-6)
    assert s["phases"]["forward"] == pytest.approx((2 + 1) * 8e-6)
    assert s["phases"]["backward"] == pytest.approx((2 + 1) * 8e-6)
    assert s["phases"]["optimizer"] == pytest.approx((2 + 1) * 8e-6)
    # a map from an earlier window places a later replay, and a one-phase
    # program places every event of a replay that lost some
    _write(str(tmp_path / "later"), _graph_trace(0, [(n, "p8"),
                                                     (n - 2, "p8")])[1:])
    later = parse_trace_dir(str(tmp_path / "later"),
                            {"p8": ["hvd_decode"] * n})
    assert later["phases"]["decode"] == pytest.approx((2 * n - 2) * 8e-6)
    assert later["unmatched"] == 0 and later["graphs"]["p8"]["lost"] == 2
    # more events than nodes is no loss: nothing is placed
    _write(str(tmp_path / "more"), _graph_trace(0, [(n + 1, "p8")])[1:])
    more = parse_trace_dir(str(tmp_path / "more"),
                           {"p8": ["hvd_decode"] * n})
    assert more["unmatched"] == n + 1 and more["phases"]["decode"] == 0.0


@pytest.mark.parametrize("kept, unmatched", [
    (range(11), 0),             # the last node lost
    (range(4, 12), 0),          # the first four lost (a window's start)
    ([0, 1, 2, 5, 6, 7, 10, 11], 0),
    # nodes 3 and 4 share a name and 4 is lost: node 3's event may be
    # either, across the forward/backward boundary
    ("pairs", 1),
])
def test_a_lossy_replay_is_placed_by_the_names_of_a_whole_one(tmp_path,
                                                             kept,
                                                             unmatched):
    """A replay that lost records takes each event's node from the kernel
    names of a replay of the same program that lost none: the nodes a
    matching of the names allows, placed where they share one phase."""
    n = 12  # nodes 0-3 forward, 4-7 backward, 8-11 optimizer
    name = "k{}".format
    if kept == "pairs":
        name, kept = (lambda i: f"k{(i + 1) // 2}"), [
            i for i in range(n) if i != 4]
    kept = list(kept)
    _write(str(tmp_path), _graph_trace(n, [(kept, "p3"), (n, "p3")],
                                       name=name))
    s = parse_trace_dir(str(tmp_path))
    lost = n - len(kept)
    assert s["graphs"]["p3"] == {"nodes": n, "events": 2 * n - lost,
                                 "unmatched": unmatched, "lost": lost}
    for ph, nodes in (("forward", range(4)), ("backward", range(4, 8)),
                      ("optimizer", range(8, 12))):
        placed = sum(i in nodes for i in kept) - (unmatched
                                                  and ph == "forward")
        assert s["phases"][ph] == pytest.approx((4 + placed) * 8e-6), ph
    assert s["phases"]["other"] == pytest.approx(unmatched * 8e-6 + 1e-6)
    # with no whole replay in the capture, event i is node i..i+lost
    _write(str(tmp_path / "alone"), _graph_trace(n, [(kept, "p3")],
                                                 name=name))
    alone = parse_trace_dir(str(tmp_path / "alone"))
    want = sum(i // 4 != (i + lost) // 4 for i in range(len(kept)))
    assert alone["unmatched"] == want > unmatched


def test_parse_trace_dir_missing_empty_malformed(tmp_path):
    assert parse_trace_dir(str(tmp_path / "nope")) is None
    assert parse_trace_dir(str(tmp_path)) is None
    assert parse_trace_dir("") is None
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "a.trace.json").write_text("this is not json")
    (bad / "b.trace.json.gz").write_bytes(b"\x1f\x8b\x08garbage")
    (bad / "c.trace.json").write_text('{"traceEvents": "not a list"}')
    assert parse_trace_dir(str(bad)) is None
    # user ranges alone are no device or host work
    _write(str(bad / "sub"), [{"ph": "X", "cat": "user_annotation",
                               "name": "hvd_forward", "ts": 0, "dur": 5,
                               "pid": 0, "tid": 0}])
    assert parse_trace_dir(str(bad)) is None


class _FakeProfile:
    """torch.profiler.profile's surface as the tracer uses it, writing
    an empty capture."""

    def __init__(self, activities=None, schedule=None):
        self.steps = 0

    def start(self):
        pass

    def step(self):  # the warm-up's end: recording starts
        self.steps += 1

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


def test_tick_owner_locking_and_window(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    tr = StepTracer(diag_dir=str(tmp_path))
    a, b = object(), object()
    tr.tick(owner=a)  # not armed: pure no-op
    assert not tr.active and tr.captures == 0
    tr.arm(2)
    tr.tick(owner=a)  # first tick starts the window, warmed up
    assert tr.active and tr.wants_phase_map("p1")
    assert tr._prof.steps == 1
    tr.register_phase_map("p1")
    assert not tr.wants_phase_map("p1")
    tr.tick(owner=b)  # foreign ticker: owner lock ignores it
    assert tr._seen == 0
    tr.tick(owner=a)
    assert tr._seen == 1 and tr.active
    tr.tick(owner=a)  # second counted step closes the window
    assert not tr.active and tr.captures == 1
    assert tr.last_summary is None
    meta = xla_trace.load_meta(tr.last_dir)
    assert meta["steps"] == 2 and meta["summary"] is None
    # a second window claims the next directory
    tr.arm(1)
    tr.tick()
    tr.tick()
    assert tr.last_dir.endswith("xla-trace-002") and tr.captures == 2


def _small_step():
    cfg = tfm.TransformerConfig(dtype=torch.float32, vocab_size=64,
                                d_model=32, n_heads=4, n_kv_heads=2,
                                n_layers=2, d_ff=64, max_seq=32,
                                positional="rope")
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), lr=1e-3),
        named_parameters=lm.named_parameters())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (2, 32)))
    return lm, opt, tokens, torch.roll(tokens, -1, 1)


def test_trace_steps_compiled_end_to_end(tmp_path):
    from horovod_tpu_torch import metrics
    hvd.init(device="cpu")
    try:
        lm, opt, tokens, targets = _small_step()
        step = hvd.compiled_train_step(lm.loss, opt, name="trace.e2e")
        for _ in range(2):
            step(tokens, targets)
        caps0 = metrics.XLA_TRACE_CAPTURES.value()
        tr = hvd.trace_steps(2, out_dir=str(tmp_path))
        assert tr.armed and xla_trace.get() is tr
        for _ in range(4):
            step(tokens, targets)
        assert tr.captures == 1 and not tr.active
        s = tr.last_summary
        for phase in ("forward", "backward", "exchange", "optimizer"):
            assert s["phases"][phase] > 0.0, phase
        # the step's own host ops outside the ranges are few
        assert s["phases"]["other"] < 0.1 * s["total_s"]
        meta = xla_trace.load_meta(tr.last_dir)
        assert meta["steps"] == 2 and meta["summary"]["events"] > 0
        assert meta["wall_elapsed_s"] > 0
        assert metrics.XLA_TRACE_CAPTURES.value() == caps0 + 1
        snap = metrics.snapshot()
        assert snap["hvd_xla_phase_seconds"]["values"][
            'phase="forward"'] > 0.0
        assert step.flops_per_step > 0.0
        assert metrics.STEP_FLOPS_TOTAL.value() >= step.flops_per_step
        assert step.perf_signature.endswith("|hooks")
    finally:
        xla_trace.uninstall()
        hvd.shutdown()


def test_flops_count_once_a_signature():
    """The warm-up call's FLOPs: FlopCounterMode over the step (on the
    CPU the attention's plain version is plain torch and counted there),
    and nothing counted again on later calls."""
    hvd.init(device="cpu")
    try:
        lm, opt, tokens, targets = _small_step()
        step = hvd.compiled_train_step(lm.loss, opt)
        step(tokens, targets)
        first = step.flops_per_step
        step(tokens, targets)
        assert first > 0 and step.flops_per_step == first
        prog = next(iter(hvd.runtime.live_state().programs._programs
                         .values()))
        assert prog.flops == first
    finally:
        hvd.shutdown()


def test_flash_wrappers_count_their_own_flops():
    from horovod_tpu_torch.ops import flash_attention as fa
    # 4 / 6 / 8 x D a live pair; causal S 8: 36 pairs a row
    sizes, tail = (2, 8, 4, 2, 16), (0.25, 1, 0)
    assert fa._launch_flops("flash_fwd", sizes, tail) == 4 * 16 * 36 * 2 * 4
    assert fa._launch_flops("flash_bwd_dq", sizes, tail) \
        == 6 * 16 * 36 * 2 * 4
    assert fa._launch_flops("flash_bwd_dkv", sizes, (0.25, 0, 0)) \
        == 8 * 16 * 64 * 2 * 4
    # a window of 3: pairs 1 + 2 + 3 * 6
    assert fa._launch_flops("flash_fwd", sizes, (0.25, 1, 3)) \
        == 4 * 16 * 21 * 2 * 4
    # a band tile at offset 8, window 8: every row sees 8 keys but the
    # last, which sees 7... rows see keys i+1..7 of the visiting tile
    lo, hi = fa.band_key_span(8, 8, 8)
    band = int((hi - lo + 1).clamp(min=0).sum())
    assert fa._launch_flops("flash_band_fwd", sizes, (0.25, 8, 8)) \
        == 4 * 16 * band * 2 * 4
    with fa.count_flops() as total:
        assert total == [0]
    assert fa._flops is None


def test_eager_loop_ticked_by_telemetry_callback(tmp_path):
    from torch.profiler import record_function

    from horovod_tpu_torch.callbacks import TelemetryCallback
    hvd.init(device="cpu")
    try:
        lm, opt, tokens, targets = _small_step()
        tr = hvd.trace_steps(2, out_dir=str(tmp_path))
        cb = TelemetryCallback(batch_size=2, skew_interval=0)
        for i in range(4):
            cb.on_batch_begin(i)
            opt.zero_grad(set_to_none=True)
            with record_function("hvd_forward"):
                loss = lm.loss(tokens, targets)
            with record_function("hvd_backward"):
                loss.backward()
            with record_function("hvd_optimizer"):
                opt.step()
            cb.on_batch_end(i)
        assert tr.captures == 1 and not tr.active
        s = tr.last_summary
        assert s["phases"]["forward"] > 0 and s["phases"]["backward"] > 0
        assert s["phases"]["exchange"] > 0 and s["phases"]["optimizer"] > 0
    finally:
        xla_trace.uninstall()
        hvd.shutdown()


def test_disabled_by_default_builds_no_state():
    from horovod_tpu_torch.diag import sentry
    hvd.init(device="cpu")
    try:
        assert xla_trace.get() is None
        assert sentry.get() is None
        diag_dir = os.environ["HOROVOD_DIAG_DIR"]
        entries = os.listdir(diag_dir) if os.path.isdir(diag_dir) else []
        assert not [d for d in entries if d.startswith("xla-trace")]
        assert not [d for d in entries if d.startswith("perf-baseline")]
    finally:
        hvd.shutdown()


def test_env_knob_installs_armed_tracer(monkeypatch):
    from horovod_tpu_torch.config import Config
    monkeypatch.setenv("HOROVOD_XPROF_STEPS", "3")
    cfg = Config.from_env()
    assert cfg.xprof_steps == 3
    try:
        tr = xla_trace.install(cfg)
        assert tr is not None and tr.armed
        assert xla_trace.get() is tr
    finally:
        xla_trace.uninstall()
    monkeypatch.setenv("HOROVOD_XPROF_STEPS", "0")
    assert xla_trace.install(Config.from_env()) is None
    assert xla_trace.get() is None


def test_cli_xla_trace_merge(tmp_path, capsys):
    from horovod_tpu_torch.diag.__main__ import main
    tdir = tmp_path / "xla-trace-001"
    _write(str(tdir), _graph_trace(3, [(3, "p3")]))
    summary = parse_trace_dir(str(tdir))
    (tdir / xla_trace.META_FILENAME).write_text(json.dumps(
        {"version": 1, "rank": 0, "steps": 1, "wall_start": 100.0,
         "wall_stop": 101.0, "wall_elapsed_s": 1.0, "summary": summary,
         "op_map": summary["op_map"]}))
    (tmp_path / "flight-rank0.json").write_text(json.dumps(
        {"rank": 0, "events": [{"seq": 0, "t": 0.0, "wall": 100.2,
                                "ev": "step", "dt": 0.1, "step": 1}]}))
    merged = tmp_path / "merged.json"
    rep_path = tmp_path / "report.json"
    rc = main([str(tmp_path), "--xla-trace", str(tdir),
               "--trace", str(merged), "--json", str(rep_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "forward=" in out and "optimizer=" in out
    rep = json.loads(rep_path.read_text())
    assert rep["xla"]["phases"]["forward"] > 0.0
    assert rep["xla"]["aligned"] is True
    evs = json.loads(merged.read_text())
    dev = [e for e in evs if e.get("cat") in ("forward", "backward",
                                              "optimizer", "other")]
    assert len(dev) == 4 and all(e["ts"] >= 0 for e in dev)
    # the replayed nodes by the map; the executed fill outside the ranges
    assert sorted(e["name"] for e in dev) == [
        "backward:k1", "forward:k0", "optimizer:k2", "other:fill"]


def test_cli_xla_trace_without_flight_dumps(tmp_path, capsys):
    from horovod_tpu_torch.diag.__main__ import main
    tdir = tmp_path / "xla-trace-001"
    _write(str(tdir), _synthetic(0, 4)[2])
    rc = main([str(tmp_path), "--xla-trace", str(tdir)])
    assert rc == 0
    assert "xla device trace" in capsys.readouterr().out


@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guard"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_step_exchanges_inside_the_optimizer(stage, guarded, tmp_path,
                                                  monkeypatch):
    """A ZeRO step at one rank: the scatter and the stripe's gather land
    in ``exchange`` (inside ``optimizer.step()`` at stages 1-2, at the
    top of the resident step at 3), the stripe's update in ``optimizer``,
    the guard's stripe row and its gate in ``guard``, and no collective
    outside every ``hvd_`` range."""
    from torch_rank_workers import host_op_phases
    monkeypatch.setenv("HOROVOD_GUARD", "1" if guarded else "0")
    hvd.init(device="cpu")
    try:
        cfg = tfm.TransformerConfig(dtype=torch.float32, vocab_size=64,
                                    d_model=32, n_heads=4, n_kv_heads=2,
                                    n_layers=1, d_ff=64, max_seq=32)
        lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(lm.parameters(), lr=1e-3),
            named_parameters=lm.named_parameters(), zero_stage=stage)
        step = hvd.compiled_train_step(lm.loss, opt)
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, 64, (2, 32)))
        step(tokens, torch.roll(tokens, -1, 1))
        tr = hvd.trace_steps(1, out_dir=str(tmp_path))
        for _ in range(2):
            step(tokens, torch.roll(tokens, -1, 1))
        step.finish()
        s = tr.last_summary
        assert s["phases"]["exchange"] > 0 and s["phases"]["optimizer"] > 0
        assert (s["phases"]["guard"] > 0) == guarded
        # one rank stages nothing: no tier ranges
        assert s["stages"] == {"ici": 0.0, "dcn": 0.0}
    finally:
        xla_trace.uninstall()
        hvd.shutdown()
    ops = {}
    for ev, phase in host_op_phases(tr.last_dir, (
            "c10d::_allgather_base_", "c10d::_reduce_scatter_base_",
            "c10d::allreduce_", "aten::isfinite")):
        ops.setdefault(ev["name"], set()).add(phase)
    assert ops["c10d::_allgather_base_"] == {"exchange"}, ops
    assert ops["c10d::_reduce_scatter_base_"] == {"exchange"}, ops
    # a group of one rank sums no row
    assert "c10d::allreduce_" not in ops, ops
    assert ops.get("aten::isfinite") == ({"guard"} if guarded else None), ops


def test_moe_bench_reads_the_alltoall_over_two_ranks():
    """The MoE bench at an expert group of 2 gloo ranks: the traced
    steps' dispatch and combine all-to-alls give ``alltoall_ms_per_step``
    and the share of them the expert FFN hides. Both directions count:
    each chunk's combine holds its forward and its reverse all-to-all,
    the dispatch its forward (the bench's tokens are data and carry no
    gradient back, as in the reference's bench), and no all-to-all runs
    outside the two."""
    from torch_ranks import spawn_ranks
    from torch_rank_workers import moe_bench_trace
    # the expert mesh at init: the bench's re-init over a new TCPStore at
    # the same port races (ROADMAP.md, Queue 3)
    rows = spawn_ranks(2, moe_bench_trace, timeout=120,
                       env={"HOROVOD_EXPERT_PARALLEL": "2"})
    for row in rows:
        assert row["expert_parallel"] == 2 and row["moe_chunks"] == 2
        phases = row["step_phase_breakdown"]
        assert phases["dispatch"] > 0 and phases["combine"] > 0
        assert phases["expert"] > 0
        assert row["alltoall_ms_per_step"] == pytest.approx(
            phases["dispatch"] + phases["combine"], abs=2e-3)
        assert 0.0 <= row["alltoall_hidden_frac"] <= 1.0
        chunks = row["moe_chunks"]
        assert row["alltoalls_per_step"] == {"dispatch": chunks,
                                             "combine": 2 * chunks}
