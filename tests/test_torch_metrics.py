"""The port's diagnostics metric families and exporters
(horovod_tpu_torch/metrics.py) against the JAX package's
(horovod_tpu/metrics.py): the families this slice adds under the same
names, help texts, labels and kinds; identical Prometheus text and
compact snapshots for identically fed registries; the JSONL and
textfile sinks and the HTTP scrape; ``init()`` with
``HOROVOD_METRICS_DIR`` and ``HOROVOD_METRICS_PORT``; and
``TelemetryCallback``'s step telemetry, its skew over 2 gloo ranks."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import horovod_tpu_torch as hvd
from horovod_tpu import metrics as jax_metrics
from horovod_tpu_torch import metrics
from horovod_tpu_torch.config import Config
from torch_ranks import spawn_ranks
from torch_rank_workers import telemetry_skew

# The families of the diagnostics slice, by their module names.
FAMILIES = ("DIAG_EVENTS", "DIAG_DUMPS", "DIAG_STALLS",
            "DIAG_DESYNC_MISSING", "DIAG_PHASE_SECONDS",
            "XLA_TRACE_CAPTURES", "XLA_PHASE_SECONDS", "PERF_REGRESSIONS",
            "STEPS_TOTAL", "STEP_SECONDS", "EXAMPLES_PER_SEC", "STEP_SKEW",
            "STEP_SKEW_MAX", "STEP_SKEW_MEDIAN", "STEP_FLOPS_TOTAL",
            "STEP_MFU", "EXCHANGE_HIDDEN_FRAC", "DEVICE_BYTES_IN_USE",
            "DEVICE_PEAK_BYTES", "DEVICE_BYTES_LIMIT",
            "MOE_ALLTOALL_HIDDEN_FRAC", "WIRE_STAGE_SECONDS")


@pytest.mark.parametrize("attr", FAMILIES)
def test_family_matches_the_reference(attr):
    port, ref = getattr(metrics, attr), getattr(jax_metrics, attr)
    assert (port.name, port.help, port.labelnames, port.kind) == (
        ref.name, ref.help, ref.labelnames, ref.kind)
    if port.kind == "histogram":
        assert port.buckets == ref.buckets
    assert metrics.registry()._families[port.name] is port


def _feed(mod, seed):
    """A fresh registry of each kind of family, fed a seeded sequence."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("t_calls_total", "Calls \"quoted\"\nnewline.",
                    labelnames=("op",))
    g = reg.gauge("t_depth", "Depth.")
    h = reg.histogram("t_lat_seconds", "Latency.", labelnames=("phase",),
                      buckets=(0.001, 0.01, 0.1))
    reg.gauge("t_zero", "Never set.")
    for _ in range(30):
        c.labels(op=("ar", "ag", 'w"x')[int(rng.integers(0, 3))]).inc(
            float(rng.integers(1, 5)))
        g.set(float(rng.uniform(-2, 2)))
        h.labels(phase=("prefill", "decode")[int(rng.integers(0, 2))]) \
            .observe(float(rng.exponential(0.02)))
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_render_prometheus_matches_the_reference(seed):
    port = metrics.render_prometheus(_feed(metrics, seed).snapshot())
    ref = jax_metrics.render_prometheus(_feed(jax_metrics, seed).snapshot())
    assert port == ref
    assert '# TYPE t_lat_seconds histogram' in port
    assert 't_lat_seconds_bucket{phase="decode",le="+Inf"}' in port


def test_compact_snapshot_matches_the_reference(monkeypatch):
    for mod in (metrics, jax_metrics):
        monkeypatch.setattr(mod, "_registry", _feed(mod, 7))
    assert metrics.compact_snapshot() == jax_metrics.compact_snapshot()
    assert "t_zero" not in metrics.compact_snapshot()


def _exporters(tmp_path, port=None):
    cfg = Config()
    cfg.metrics_dir = str(tmp_path)
    cfg.metrics_port = -1 if port is None else port
    cfg.metrics_interval = 60.0  # ticks driven by hand
    return metrics.MetricsExporters(cfg, process_index=0)


def test_jsonl_and_textfile_round_trip(tmp_path):
    metrics.STEP_SECONDS.observe(0.123)
    metrics.STEP_SKEW.set(1.5)
    exp = _exporters(tmp_path)
    try:
        exp.tick()
    finally:
        exp.close()
    lines = [json.loads(line) for line in
             (tmp_path / "metrics-0.jsonl").read_text().splitlines()]
    assert len(lines) == 2  # the tick and close()'s final export
    rec = lines[-1]["metrics"]
    assert rec["hvd_step_seconds"][""]["count"] >= 1
    assert rec["hvd_step_time_skew"][""] == 1.5
    text = (tmp_path / "metrics-0.prom").read_text()
    assert text == metrics.render_prometheus(metrics.snapshot())
    assert any(line.startswith("hvd_step_time_skew 1.5")
               for line in text.splitlines())
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name_part, _, value = line.rpartition(" ")
            assert name_part and float(value) is not None
    assert metrics.start_exporters(Config()) is None  # nothing configured
    with pytest.raises(NotImplementedError, match="item 10"):
        metrics.MetricsExporters(Config(), timeline=object())


def test_http_scrape_endpoint(tmp_path):
    exp = _exporters(tmp_path, port=0)  # 0: an ephemeral port
    try:
        assert exp.http_port
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{exp.http_port}/metrics", timeout=10).read()
        assert b"# TYPE hvd_xla_trace_captures_total counter" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{exp.http_port}/nope", timeout=10)
    finally:
        exp.close()
    with pytest.raises(Exception):
        urllib.request.urlopen(
            f"http://127.0.0.1:{exp.http_port}/metrics", timeout=2)


def test_init_runs_the_exporters(monkeypatch, tmp_path):
    """HOROVOD_METRICS_DIR and HOROVOD_METRICS_PORT no longer make init()
    raise: the session exports, and shutdown's last export says hvd_up
    0."""
    monkeypatch.setenv("HOROVOD_METRICS_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_METRICS_PORT", "0")
    hvd.init(device="cpu")
    try:
        exp = hvd.runtime.live_state().metrics_exporters
        assert exp is not None and exp.active and exp.http_port
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{exp.http_port}/metrics", timeout=10).read()
        assert b"hvd_up 1.0" in body
    finally:
        hvd.shutdown()
    assert hvd.runtime._state.metrics_exporters is None
    prom = (tmp_path / "metrics-0.prom").read_text()
    assert "hvd_up 0.0" in prom.splitlines()
    last = json.loads((tmp_path / "metrics-0.jsonl").read_text()
                      .splitlines()[-1])
    assert last["metrics"]["hvd_up"][""] == 0.0


def test_telemetry_callback_step_gauges():
    from horovod_tpu_torch.callbacks import TelemetryCallback
    from horovod_tpu_torch.diag import recorder
    hvd.init(device="cpu")
    try:
        steps0 = metrics.STEPS_TOTAL.value()
        count0 = metrics.STEP_SECONDS.value()["count"]
        cb = TelemetryCallback(skew_interval=1)
        cb.set_params({"batch_size": 32})
        for i in range(3):
            cb.on_batch_begin(i)
            cb.on_batch_end(i)
        assert metrics.STEPS_TOTAL.value() == steps0 + 3
        assert metrics.STEP_SECONDS.value()["count"] == count0 + 3
        assert metrics.EXAMPLES_PER_SEC.value() > 0
        # one rank: a balanced mesh
        assert metrics.STEP_SKEW.value() == pytest.approx(1.0)
        marks = [e for e in recorder.get().snapshot() if e["ev"] == "step"]
        assert [e["step"] for e in marks] == [1, 2, 3]
        # the flight recorder's phase gauges, on the skew cadence
        phases = metrics.snapshot()["hvd_diag_phase_seconds"]["values"]
        assert set(phases) >= {'phase="wire"', 'phase="readback"',
                               'phase="input"'}
    finally:
        hvd.shutdown()


def test_telemetry_callback_policy_signal_and_mfu(tmp_path, monkeypatch):
    from horovod_tpu_torch.callbacks import TelemetryCallback

    class Step:  # what the callback reads of a compiled step
        flops_per_step = 2e9
        perf_signature = "abc|hooks"
        cache_hit_rate = 1.0
        fallback_steps = 0

    monkeypatch.setenv("HOROVOD_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("HOROVOD_PERF_SENTRY", "1")
    monkeypatch.setenv("HOROVOD_METRICS_DIR", str(tmp_path / "m"))
    hvd.init(device="cpu")
    try:
        from horovod_tpu_torch.diag import sentry
        cb = TelemetryCallback(batch_size=8, skew_interval=0,
                               policy_dir=str(tmp_path), signal_interval=0,
                               compiled_step=Step())
        cb.on_batch_begin(0)
        cb.on_batch_end(0)
        signal = json.loads((tmp_path / "signals-0.json").read_text())
        assert signal["step"] == 1 and signal["compiled_hit_rate"] == 1.0
        assert signal["mfu"] == pytest.approx(metrics.STEP_MFU.value())
        assert 0 < signal["mfu"]
        assert list(sentry.get()._baselines) == ["abc|hooks|b8|w1"]
    finally:
        hvd.shutdown()


def test_telemetry_callback_skew_over_two_ranks():
    out = spawn_ranks(2, telemetry_skew, 0.1, timeout=90)
    for r in out:
        assert r["steps"] == 2 and r["examples"] > 0
        # rank 1 sleeps twice rank 0's: max/median of two times
        assert r["max"] >= 0.2 and r["median"] >= 0.1
        assert r["skew"] == pytest.approx(r["max"] / r["median"])
        assert r["skew"] > 1.1
    # every rank exports the same gathered sample
    assert out[0]["skew"] == out[1]["skew"]
