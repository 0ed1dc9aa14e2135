"""The port's autotuner (horovod_tpu_torch/autotune.py) against the JAX
package's (horovod_tpu/autotune.py), and its wiring into the eager
engine, the decision log and the data loader.

Parity: the numpy GP's posterior mean and std (rtol 1e-9); the numpy
Bayesian optimizer's suggestions (exact), and the native one's
(csrc/gaussian_process.cc, the same C++ source in both packages;
exact); a ParameterManager fed one synthetic stream of byte, wire,
overlap and input-wait records writes the same CSV bytes and applies
the same parameters as the JAX one, the largest-message guard and the
prefetch tuner included. The score divides by a window's wall time, so
both managers run on one scripted clock (``time.perf_counter``
patched), each from the same start.

Behavioral spec: tests/test_autotune.py,
test_overlap_pipeline.py::test_autotune_tunes_depth_and_overlap,
test_device_resident.py::test_autotune_largest_message_guard and
test_data_pipeline.py's autotune tests.
"""

import itertools
import time
import types

import numpy as np
import pytest
import torch

import horovod_tpu.autotune as jat
from horovod_tpu import native as jnative
from horovod_tpu.config import Config as JConfig
from horovod_tpu_torch import autotune as pat
from horovod_tpu_torch import native as pnative
from horovod_tpu_torch.config import Config as PConfig
from torch_ranks import spawn_ranks
from torch_launch_workers import autotune_session


def _cfg(cls, **kw):
    cfg = cls()
    cfg.autotune = True
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture
def clock(monkeypatch):
    """A scripted ``time.perf_counter``: each call advances 1 ms, so a
    window's elapsed time is a function of the calls made, the same for
    both managers. ``reset()`` restarts it for the second manager."""
    state = {"it": None}

    def reset():
        state["it"] = itertools.count()

    def fake():
        return 1000.0 + 1e-3 * next(state["it"])

    reset()
    monkeypatch.setattr(time, "perf_counter", fake)
    return reset


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's ParameterManager on a native optimizer: its own
    library where it builds, else the port's copy of the same source."""
    if not jnative.available():
        monkeypatch.setattr(jnative, "available", lambda: True)
        monkeypatch.setattr(jnative, "get_lib", pnative.get_lib)
    return jnative.get_lib()


# ----------------------------------------------------------------- the GP


def test_gp_matches_the_reference():
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(14, 2))
    y = np.sin(3 * x[:, 0]) + np.cos(2 * x[:, 1])
    q = rng.uniform(size=(40, 2))
    pg, jg = pat.GaussianProcessRegressor(), jat.GaussianProcessRegressor()
    pg.fit(x, y)
    jg.fit(x, y)
    assert pg.length_scale == jg.length_scale
    (pm, ps), (jm, js) = pg.predict(q), jg.predict(q)
    np.testing.assert_allclose(pm, jm, rtol=1e-9, atol=0)
    np.testing.assert_allclose(ps, js, rtol=1e-9, atol=0)


def test_gp_fits_smooth_function():
    gp = pat.GaussianProcessRegressor()
    x = np.linspace(0, 1, 12)[:, None]
    y = np.sin(2 * np.pi * x[:, 0])
    gp.fit(x, y)
    mu, sigma = gp.predict(x)
    np.testing.assert_allclose(mu, y, atol=0.05)
    assert (sigma < 0.2).all()


def _samples(n=9):
    rng = np.random.default_rng(5)
    xs = rng.uniform([0.0, 1.0], [64.0 * 2 ** 20, 25.0], size=(n, 2))
    ys = -((xs[:, 0] / 2 ** 26 - 0.3) ** 2) - ((xs[:, 1] - 8) / 25) ** 2
    return xs, ys


def test_numpy_suggestions_match_the_reference():
    pb = pat.BayesianOptimization(pat.ParameterManager.BOUNDS)
    jb = jat.BayesianOptimization(jat.ParameterManager.BOUNDS)
    prng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for x, y in zip(*_samples()):
        pb.add_sample(x, y)
        jb.add_sample(x, y)
        np.testing.assert_array_equal(pb.suggest(prng), jb.suggest(jrng))


def test_native_suggestions_match_the_reference(jax_native):
    bounds = pat.ParameterManager.BOUNDS
    pb = pat._NativeBayesianOptimization(pnative.get_lib(), bounds)
    jb = jat._NativeBayesianOptimization(jax_native, bounds)
    for x, y in zip(*_samples()):
        pb.add_sample(x, y)
        jb.add_sample(x, y)
        got, want = pb.suggest(), jb.suggest()
        np.testing.assert_array_equal(got, want)
        assert 0.0 <= got[0] <= 64.0 * 2 ** 20 and 1.0 <= got[1] <= 25.0


def test_bayes_opt_finds_peak():
    rng = np.random.default_rng(1)
    bo = pat.BayesianOptimization([(0.0, 1.0)], xi=0.01)
    x = np.array([0.1])
    for _ in range(25):
        bo.add_sample(x, -((x[0] - 0.7) ** 2))
        x = bo.suggest(rng)
    best_x = bo._xs[int(np.argmax(bo._ys))][0]
    assert abs(best_x - 0.7) < 0.15


# ------------------------------------------------------ ParameterManager


def _drive(pm, cfg, stream):
    """Feed one synthetic record stream; returns the parameters in force
    after each record."""
    applied = []
    for kind, *args in stream:
        getattr(pm, kind)(*args)
        applied.append((cfg.fusion_threshold, cfg.cycle_time_ms,
                        cfg.padding_algo, cfg.pipeline_depth,
                        cfg.data_prefetch))
    return applied


def _stream():
    """Bytes, wire spans at several sizes (one window whose large-message
    goodput collapses, for the guard), overlap and input waits."""
    out = []
    rng = np.random.default_rng(11)
    for w in range(14):
        if w == 3:
            out.append(("record_prefetch_depth", 4))
        for k in range(3):
            nb = int(rng.integers(1, 8)) << 20
            span = 1e-3 * nb / 2 ** 20 * (40.0 if w == 5 else 1.0)
            out.append(("record_wire", nb, span))
            out.append(("record_overlap", 0.002 * (k + 1), 0.001))
            if w % 4 != 3:
                out.append(("record_input_wait",
                            0.5 if w < 6 else 0.0))
            out.append(("record_bytes", nb * (1 + w % 3)))
    return out


@pytest.mark.parametrize("depth,prefetch", [(2, 2), (0, 0)])
def test_parameter_manager_matches_the_reference(tmp_path, clock,
                                                 jax_native, depth,
                                                 prefetch):
    """The same stream through both managers: the same CSV, byte for
    byte, the same parameters after every record, the same incumbent
    (guard rejections included), and the same converged state."""
    kw = dict(autotune_warmup_samples=1, autotune_steps_per_sample=3,
              autotune_bayes_opt_max_samples=10, pipeline_depth=depth,
              data_prefetch=prefetch)
    pcfg = _cfg(PConfig, autotune_log=str(tmp_path / "p.csv"), **kw)
    jcfg = _cfg(JConfig, autotune_log=str(tmp_path / "j.csv"), **kw)
    clock()
    pm = pat.ParameterManager(pcfg)
    got = _drive(pm, pcfg, _stream())
    clock()
    jm = jat.ParameterManager(jcfg)
    want = _drive(jm, jcfg, _stream())
    assert got == want
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert pm._best == jm._best
    assert pm.active == jm.active is False
    rows = pm._log_rows
    assert len(rows) == 10
    assert any(r[-2] == 1 for r in rows) == any(r[-2] == 1
                                                for r in jm._log_rows)
    if depth:
        assert len({r[4] for r in rows}) > 1  # depth explored
    else:
        assert {r[4] for r in rows} == {0}  # synchronous mode kept


def test_parameter_manager_tunes_and_converges(tmp_path):
    cfg = _cfg(PConfig, autotune_warmup_samples=1,
               autotune_steps_per_sample=2,
               autotune_bayes_opt_max_samples=4,
               autotune_log=str(tmp_path / "autotune.csv"))
    pm = pat.ParameterManager(cfg)
    for _ in range(2 * (1 + 4) + 2):
        pm.record_bytes(1 << 20)
    assert not pm.active
    text = (tmp_path / "autotune.csv").read_text()
    assert text.startswith("sample,fusion_threshold,cycle_time_ms")
    assert len(text.strip().splitlines()) == 5


def test_parameter_manager_categorical_padding_and_depth(tmp_path):
    cfg = _cfg(PConfig, autotune_warmup_samples=0,
               autotune_steps_per_sample=1,
               autotune_bayes_opt_max_samples=12, pipeline_depth=2,
               autotune_log=str(tmp_path / "at.csv"))
    pm = pat.ParameterManager(cfg)
    pads, depths = set(), set()
    for _ in range(12):
        pm.record_overlap(0.8, 0.2)
        pm.record_bytes(1 << 20)
        pads.add(cfg.padding_algo)
        depths.add(cfg.pipeline_depth)
    assert pads == {0, 1} and depths >= {1, 2, 4}
    assert not pm.active
    assert (cfg.padding_algo, cfg.pipeline_depth) == pm._best[3:5]
    header = (tmp_path / "at.csv").read_text().splitlines()[0]
    assert "pipeline_depth" in header and "comm_hidden_frac" in header
    assert header.endswith("overlap_adjusted_bytes_per_sec")


def test_autotune_largest_message_guard(tmp_path):
    cfg = _cfg(PConfig, autotune_warmup_samples=0,
               autotune_steps_per_sample=1,
               autotune_bayes_opt_max_samples=10,
               autotune_log=str(tmp_path / "autotune.csv"))
    pm = pat.ParameterManager(cfg)
    pm.record_wire(1 << 20, 0.001)
    pm.record_bytes(1 << 20)
    incumbent = pm._best
    assert incumbent[0] > 0
    # a far higher overall score, but the large-message goodput collapsed
    pm.record_wire(1 << 20, 1.0)
    pm.record_bytes(1 << 40)
    assert pm._best == incumbent
    assert pm._log_rows[-1][-2] == 1
    # a higher score and no large-message regression: accepted
    pm.record_wire(1 << 20, 0.0009)
    pm.record_bytes(1 << 40)
    assert pm._best != incumbent
    assert pm._log_rows[-1][-2] == 0
    header = (tmp_path / "autotune.csv").read_text().splitlines()[0]
    assert "largest_msg_bytes" in header and "guard_rejected" in header


def test_autotune_tunes_prefetch_depth_off_input_wait():
    cfg = _cfg(PConfig, autotune_warmup_samples=0,
               autotune_steps_per_sample=1, data_prefetch=2)
    pm = pat.ParameterManager(cfg)
    for want in (4, 8):
        pm.record_input_wait(10.0)
        pm.record_bytes(1 << 20)
        assert cfg.data_prefetch == want
    for _ in range(3):
        pm.record_input_wait(10.0)
        pm.record_bytes(1 << 20)
    assert cfg.data_prefetch == pat.ParameterManager.PREFETCH_MAX
    for _ in range(5):  # no loader reported: no decay
        pm.record_bytes(1 << 20)
    assert cfg.data_prefetch == pat.ParameterManager.PREFETCH_MAX
    for _ in range(3):  # three reported-quiet windows: one decay step
        pm.record_input_wait(0.0)
        pm.record_bytes(1 << 20)
    assert cfg.data_prefetch == pat.ParameterManager.PREFETCH_MAX - 1


def test_autotune_prefetch_waits_for_change_to_land():
    cfg = _cfg(PConfig, autotune_warmup_samples=0,
               autotune_steps_per_sample=1, data_prefetch=2)
    pm = pat.ParameterManager(cfg)
    pm.record_prefetch_depth(2)
    pm.record_input_wait(10.0)
    pm.record_bytes(1 << 20)
    assert cfg.data_prefetch == 4
    for _ in range(3):
        pm.record_input_wait(10.0)
        pm.record_bytes(1 << 20)
    assert cfg.data_prefetch == 4
    pm.record_prefetch_depth(4)
    pm.record_input_wait(10.0)
    pm.record_bytes(1 << 20)
    assert cfg.data_prefetch == 8


# ------------------------------------------------------ the engine's hooks


def _predict_buckets(lib, order_bytes, threshold):
    """The fused all-reduces of one step at one rank whose tensors reach
    the engine in this order: a cycle runs at the enqueue that brings
    the pending bytes to the threshold, and one more at the first
    synchronize; each cycle fuses what is pending through the native
    planner."""
    import ctypes

    def plan(pending):
        n = len(pending)
        groups = (ctypes.c_int32 * n)()
        return lib.hvd_fusion_plan((ctypes.c_int64 * n)(*pending),
                                   (ctypes.c_int32 * n)(), n, threshold,
                                   groups)
    pending, out = [], 0
    for nb in order_bytes:
        pending.append(nb)
        if sum(pending) >= threshold:
            out += plan(pending)
            pending = []
    return out + (plan(pending) if pending else 0)


def test_init_drives_the_engine_and_a_threshold_changes_the_buckets(
        monkeypatch, tmp_path):
    """``HOROVOD_AUTOTUNE=1`` at one rank on the CPU: process 0 holds the
    tuner and every fused all-reduce feeds it. Step 0 runs at the
    default 64 MiB (one bucket); its bucket ends the first sample, whose
    suggestion the tuner applies; with the tuner then held, step 1 runs
    at the applied threshold, and its buckets are what the planner gives
    there (more than one)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    log = tmp_path / "at.csv"
    for k, v in dict(HOROVOD_AUTOTUNE="1", HOROVOD_AUTOTUNE_LOG=str(log),
                     HOROVOD_AUTOTUNE_WARMUP_SAMPLES="0",
                     HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="1").items():
        monkeypatch.setenv(k, v)
    hvd.init(device="cpu")
    try:
        state = hvd.runtime.live_state()
        engine, tuner = state.engine, state.autotuner
        assert tuner is not None and engine.autotuner is tuner
        sizes = [2 << 20] * 12  # 12 float32 tensors of 2 MiB
        lib = pnative.get_lib()
        seen = []
        for s in range(2):
            thr = engine.config.fusion_threshold
            flushes = metrics.ENGINE_BUCKET_FLUSHES.value()
            hs = [hvd.allreduce_async(torch.full((nb // 4,), float(i)),
                                      name=f"tune.{s}.{i}")
                  for i, nb in enumerate(sizes)]
            for h in hs:
                hvd.synchronize(h)
            got = metrics.ENGINE_BUCKET_FLUSHES.value() - flushes
            assert got == _predict_buckets(lib, sizes, thr), (s, thr, got)
            seen.append((thr, got))
            tuner.active = False  # hold the applied candidate
        (t0, b0), (t1, b1) = seen
        assert t0 == 64 * 2 ** 20 and b0 == 1
        assert 0 <= t1 < t0 and b1 > 1
        assert (engine.config.fusion_threshold, engine.config.padding_algo,
                engine.config.pipeline_depth) == (t1, 1, 1)
        assert 1.0 <= engine.config.cycle_time_ms <= 25.0
        rows = log.read_text().strip().splitlines()
        assert len(rows) == 2 and rows[0].startswith("sample,")
        assert rows[1].split(",")[1] == str(t0)
    finally:
        hvd.shutdown()
    assert hvd.runtime._state.autotuner is None


class _Event:
    """A completed (or not) CUDA event stand-in at time ``t`` seconds."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_a_cards_exposed_time_is_the_consumer_streams_stall():
    """On a card the host's wait does not block, so the engine feeds the
    tuner each bucket's stall of its consumer's stream: from the event
    before the consumer's wait to the bucket's end event, 0 when the
    bucket ended first, once both completed (a pair not yet complete
    waits for a later hand-over). On the CPU the engine feeds the
    host's wait, which blocks there."""
    from horovod_tpu_torch.ops.engine import EagerEngine
    fed = []
    eng = types.SimpleNamespace(
        autotuner=types.SimpleNamespace(
            record_overlap=lambda hidden, exposed: fed.append(
                (hidden, exposed))),
        _exposure=[(_Event(1.0), _Event(1.25)),   # stalled 250 ms
                   (_Event(2.0), _Event(1.5)),    # bucket ended first
                   (_Event(3.0, done=False), _Event(3.5)),
                   (_Event(4.0), _Event(4.1, done=False))])
    EagerEngine._feed_exposure(eng)
    assert fed == [(0.0, pytest.approx(0.25)), (0.0, 0.0)]
    assert [(a.t, b.t) for a, b in eng._exposure] == [(3.0, 3.5), (4.0, 4.1)]
    for a, b in eng._exposure:
        a.done = b.done = True
    EagerEngine._feed_exposure(eng)
    assert fed[2:] == [(0.0, pytest.approx(0.5)), (0.0, pytest.approx(0.1))]
    assert eng._exposure == []


def test_loader_feeds_the_tuner(monkeypatch):
    import horovod_tpu_torch as hvd
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    hvd.init(device="cpu")
    try:
        tuner = hvd.runtime.live_state().autotuner
        ds = hvd.data.DistributedDataset(np.arange(8.0), 2, prefetch=2,
                                         device="cpu")
        assert ds._autotuner() is tuner
        waits = []
        monkeypatch.setattr(tuner, "record_input_wait", waits.append)
        list(ds)
        assert tuner._live_prefetch == 2
        assert len(waits) == 4 and all(w >= 0 for w in waits)
    finally:
        hvd.shutdown()


def test_two_ranks_apply_the_same_decisions_at_the_same_index():
    """Two gloo ranks: only process 0 tunes; its changes ride the
    decision log and both ranks apply them at the same index of their
    decision streams, with equal results every step."""
    env = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "0",
           "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
           "HOROVOD_PROFILER_DISABLE": "1"}
    got = spawn_ranks(2, autotune_session, 10, 6, 1 << 16, env=env,
                      timeout=120)
    assert [g["tuner"] for g in got] == [True, False]
    assert got[0]["applied"], "process 0 published no autotune decision"
    assert got[0]["applied"] == got[1]["applied"]
    assert got[0]["indices"] == got[1]["indices"]
    # every bucket is planned under the same threshold on both ranks,
    # and each applied threshold plans the buckets after its index
    assert got[0]["plans"] == got[1]["plans"]
    used = [t for t, _ in got[0]["plans"]]
    assert set(used[1:]) <= {used[0]} | {a[0] for a in got[0]["applied"]}
    assert got[0]["steps"] == got[1]["steps"]
    assert got[0]["digest"] == got[1]["digest"]
    for fusion, cycle, pad, depth in got[0]["applied"]:
        assert 0 <= fusion <= 64 * 2 ** 20 and 1.0 <= cycle <= 25.0
        assert pad in (0, 1) and depth in (1, 2, 4)
