"""The port's perf-regression sentry (horovod_tpu_torch/diag/sentry.py)
against the JAX package's (horovod_tpu/diag/sentry.py): one seeded
observation sequence through both gives the same verdicts and equal
baseline files; then the warm-up, MFU drops, a corrupt baseline, the
auto-armed trace window and flight event, the inert default, and the
serve engine's feed under its key strings."""

import json

import numpy as np
import pytest
import torch

from horovod_tpu.diag.sentry import PerfSentry as JaxSentry
from horovod_tpu_torch import metrics
from horovod_tpu_torch.config import Config
from horovod_tpu_torch.diag import recorder, sentry, xla_trace
from horovod_tpu_torch.diag.sentry import PerfSentry


def _regressions(kind):
    fam = metrics.snapshot().get("hvd_perf_regressions_total", {})
    return fam.get("values", {}).get(f'kind="{kind}"', 0.0)


def _warm(s, sig="sig", step=0.1, mfu=None, n=6):
    for _ in range(n):
        assert s.observe(sig, step, mfu) is None


def _sequence(seed, n=120):
    """Seeded (signature, step seconds, mfu or None) observations: three
    signatures, noise around a base, and injected slowdowns and MFU
    drops."""
    rng = np.random.default_rng(seed)
    sigs = ["a|b32|w1", "b|b8|w4|z2", "serve_decode|b8|p4"]
    out = []
    for i in range(n):
        k = int(rng.integers(0, 3))
        dt = 0.1 * (k + 1) * float(rng.uniform(0.95, 1.05))
        if rng.random() < 0.08:
            dt *= float(rng.uniform(1.3, 3.0))
        mfu = None if k == 2 else 0.4 * float(rng.uniform(0.97, 1.03))
        if mfu is not None and rng.random() < 0.06:
            mfu *= 0.5
        out.append((sigs[k], dt, mfu))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_same_observations_same_verdicts_and_baselines(tmp_path, seed):
    port = PerfSentry(threshold=0.25, baseline_dir=str(tmp_path / "port"),
                      auto_trace=False)
    ref = JaxSentry(threshold=0.25, baseline_dir=str(tmp_path / "jax"),
                    auto_trace=False)
    verdicts = []
    for sig, dt, mfu in _sequence(seed):
        got, want = port.observe(sig, dt, mfu), ref.observe(sig, dt, mfu)
        assert got == want
        verdicts.append(got)
    assert any(verdicts), "the sequence fired nothing"
    assert port.regressions == ref.regressions
    port.flush()
    ref.flush()
    name = sentry.BASELINE_FILENAME
    assert (tmp_path / "port" / name).read_text() \
        == (tmp_path / "jax" / name).read_text()
    # each resumes from the other's file alike
    again = PerfSentry(baseline_dir=str(tmp_path / "jax"), auto_trace=False)
    assert again._baselines == port._baselines


def test_fires_on_2x_step_time_slowdown(tmp_path):
    before = _regressions("step_time")
    s = PerfSentry(threshold=0.25, baseline_dir=str(tmp_path),
                   auto_trace=False)
    _warm(s)
    v = s.observe("sig", 0.2)
    assert v is not None and v["kind"] == "step_time"
    assert v["ratio"] == pytest.approx(2.0, rel=0.05)
    assert _regressions("step_time") == before + 1


def test_warmup_steps_never_fire(tmp_path):
    s = PerfSentry(threshold=0.25, baseline_dir=str(tmp_path),
                   auto_trace=False, warmup=5)
    assert s.observe("sig", 5.0) is None
    for _ in range(3):
        assert s.observe("sig", 0.1) is None
    assert s.regressions == 0


def test_fires_on_mfu_drop(tmp_path):
    before = _regressions("mfu")
    s = PerfSentry(threshold=0.25, baseline_dir=str(tmp_path),
                   auto_trace=False)
    _warm(s, step=0.1, mfu=0.5)
    v = s.observe("sig", 0.1, mfu=0.2)
    assert v is not None and v["kind"] == "mfu"
    assert _regressions("mfu") == before + 1


def test_corrupt_baseline_cold_starts(tmp_path):
    (tmp_path / sentry.BASELINE_FILENAME).write_text("{not json")
    s = PerfSentry(baseline_dir=str(tmp_path), auto_trace=False)
    assert s._baselines == {}
    _warm(s)
    # a rank above 0 keeps a file of its own
    s3 = PerfSentry(baseline_dir=str(tmp_path), rank=3)
    s3.flush()
    assert (tmp_path / "perf-baseline-rank3.json").exists()
    assert json.loads((tmp_path / "perf-baseline-rank3.json").read_text()) \
        == {"version": 1, "signatures": {}}


def test_regression_records_flight_event_and_auto_traces(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("HOROVOD_DIAG_DIR", str(tmp_path))
    rec = recorder.install(Config.from_env())
    try:
        s = PerfSentry(threshold=0.25, baseline_dir=str(tmp_path),
                       auto_trace=True)
        _warm(s)
        assert s.observe("sig", 0.3) is not None
        evs = [e for e in rec.snapshot() if e["ev"] == "perf_regression"]
        assert evs and evs[0]["op"] == "step_time"
        assert evs[0]["name"] == "sig" and evs[0]["ratio"] > 2.5
        tr = xla_trace.get()
        assert tr is not None and tr.armed
        assert tr._want == sentry.AUTO_TRACE_STEPS
        # one window a signature: a second fire arms nothing more
        tr._want = 0
        assert s.observe("sig", 0.4) is not None
        assert xla_trace.get() is tr and tr._want == 0
    finally:
        xla_trace.uninstall()
        recorder.uninstall()


def test_install_inert_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("HOROVOD_PERF_SENTRY", raising=False)
    assert sentry.install(Config.from_env()) is None
    assert sentry.get() is None
    monkeypatch.setenv("HOROVOD_PERF_SENTRY", "1")
    monkeypatch.setenv("HOROVOD_PERF_SENTRY_THRESHOLD", "0.5")
    monkeypatch.setenv("HOROVOD_METRICS_DIR", str(tmp_path))
    try:
        s = sentry.install(Config.from_env())
        assert s is not None and s.threshold == 0.5
        assert s.baseline_dir == str(tmp_path)
        _warm(s, step=0.1)
        sentry.uninstall()
        assert sentry.get() is None
        assert (tmp_path / sentry.BASELINE_FILENAME).exists()
    finally:
        sentry.uninstall()


def test_serve_engine_feeds_the_sentry(tmp_path, monkeypatch):
    """The serve engine observes every prefill and decode call under the
    JAX engine's key strings (``serve_prefill|b<bin>|s<len bin>``,
    ``serve_decode|b<bin>|p<page bin>``)."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.serve.engine import ServeEngine
    monkeypatch.setenv("HOROVOD_PERF_SENTRY", "1")
    monkeypatch.setenv("HOROVOD_METRICS_DIR", str(tmp_path))
    cfg = tfm.TransformerConfig(dtype=torch.float32, vocab_size=64,
                                d_model=32, n_heads=4, n_kv_heads=2,
                                n_layers=1, d_ff=64, max_seq=64)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s = sentry.install(Config.from_env())
    try:
        eng = ServeEngine(params, cfg, num_pages=16, page_size=8,
                          device="cpu")
        eng.cache.allocate(0, 12)
        eng.prefill([0], [list(range(1, 11))])
        eng.decode([0], [3], [10])
        keys = sorted(s._baselines)
        assert len(keys) == 2
        assert keys[0].startswith("serve_decode|b") and "|p" in keys[0]
        assert keys[1].startswith("serve_prefill|b") and "|s" in keys[1]
    finally:
        sentry.uninstall()
