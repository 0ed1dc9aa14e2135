"""The port's flight recorder, hang watchdog and diag CLI
(horovod_tpu_torch/diag/) against the JAX package's.

Both recorders, fed the same events on the same clock, give the same
ring, snapshot, phase totals and dump; both CLIs, on the same dumps,
give the same merged Chrome trace (byte for byte), report JSON and
report text. The watchdog is inert at the default timeout, and over 2
gloo ranks a late rank's stall leaves rank 0's dump and its desync
report naming the missing rank; the knobs parse as the JAX package's.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.config import Config as JaxConfig
from horovod_tpu.diag import __main__ as jax_cli
from horovod_tpu.diag.recorder import FlightRecorder as JaxRecorder
from horovod_tpu_torch.config import Config
from horovod_tpu_torch.diag import __main__ as port_cli
from horovod_tpu_torch.diag import recorder
from horovod_tpu_torch.diag.recorder import FlightRecorder
from torch_ranks import spawn_ranks
from torch_rank_workers import stall_desync

EVENTS = ("enqueue", "dispatch", "wire_end", "input_wait", "step",
          "stall_detected", "perf_regression")


class _Clock:
    """A deterministic clock for both ``time.perf_counter`` and
    ``time.time``: 1000.0, 1000.001, ... reset to replay one sequence."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return 1000.0 + 0.001 * self.n


def _feed(rec, seed, n=50):
    """A seeded sequence of lifecycle events."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        ev = EVENTS[int(rng.integers(0, len(EVENTS)))]
        extra = None
        if ev == "wire_end":
            extra = {"span": float(rng.uniform(0, 0.01)),
                     "wait": float(rng.uniform(0, 0.002))}
        elif ev == "input_wait":
            extra = {"wait": float(rng.uniform(0, 0.003))}
        elif ev == "step":
            extra = {"dt": float(rng.uniform(0.01, 0.02)), "step": i}
        rec.record(ev, name=f"AdamW.grads.bucket{i % 3}" if i % 4 else "",
                   op="allreduce" if i % 2 else "",
                   nbytes=int(rng.integers(0, 4096)),
                   dtype="float32" if i % 5 else "", extra=extra)


@pytest.mark.parametrize("seed,capacity", [(0, 64), (1, 16), (2, 5)])
def test_ring_snapshot_phase_totals_and_dump_match_the_reference(
        monkeypatch, tmp_path, seed, capacity):
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setattr(time, "time", clock)
    out = {}
    for name, cls in (("jax", JaxRecorder), ("port", FlightRecorder)):
        clock.reset()
        rec = cls(capacity=capacity, rank=1, process_index=1, digest="d",
                  diag_dir=str(tmp_path / name))
        rec.last_decision_index = 4
        _feed(rec, seed)
        assert rec.capacity == (64 if capacity == 64 else 16 if
                                capacity == 16 else 8)
        clock.reset()
        path = rec.dump(reason="manual", extra={"note": "parity"})
        dump = json.load(open(path))
        assert os.path.basename(path) == "flight-rank1.json"
        dump.pop("threads")
        out[name] = (rec.snapshot(), rec.phase_totals(),
                     rec.events_recorded, dump)
    assert out["port"] == out["jax"]


def test_both_clis_give_the_same_trace_and_report(tmp_path, capsys):
    clock = _Clock()
    dumps = tmp_path / "dumps"
    for rank in (0, 1):
        rec = FlightRecorder(capacity=64, rank=rank, process_index=rank,
                             diag_dir=str(dumps))
        _feed(rec, 10 + rank, n=40)
        path = rec.dump(reason="manual")
        d = json.load(open(path))
        # a fixed clock, so the files are the same on every run
        for e in d["events"]:
            e["t"] = e["wall"] = clock()
        json.dump(d, open(path, "w"))
    json.dump({"stalled": [{"name": "g2", "age_seconds": 5.0,
                            "entered": [0], "missing": [1],
                            "decision_index": {"0": 3}}]},
              open(dumps / "desync-report.json", "w"))
    got = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        trace, report = tmp_path / f"{name}.json", tmp_path / f"{name}.rep"
        assert cli.main([str(dumps), "--trace", str(trace),
                         "--json", str(report)]) == 0
        text = capsys.readouterr().out.replace(str(trace), "T").replace(
            str(report), "R")
        got[name] = (trace.read_bytes(), json.load(open(report)), text)
    assert got["port"] == got["jax"]
    assert b"rank1 flight" in got["port"][0]
    assert "DESYNC" in got["port"][2]


def test_cli_skips_garbage_and_errors_when_empty(tmp_path, capsys):
    (tmp_path / "flight-rank0.json").write_text("not json{")
    assert port_cli.main([str(tmp_path)]) == 2
    assert "no readable flight dumps" in capsys.readouterr().err


def test_dump_format_and_thread_stacks(tmp_path):
    fr = FlightRecorder(capacity=16, rank=3, process_index=1,
                        digest="abc123", diag_dir=str(tmp_path))
    fr.record("enqueue", name="AdamW.grads.bucket0", op="allreduce",
              nbytes=400, dtype="float32")
    path = fr.dump(reason="stall", extra={"note": "test"})
    assert path == str(tmp_path / "flight-rank3.json")
    d = json.load(open(path))
    assert (d["version"], d["reason"], d["rank"], d["pid"]) == (
        1, "stall", 3, 1)
    assert d["note"] == "test"
    assert d["events"][0]["name"] == "AdamW.grads.bucket0"
    assert any("test_dump_format_and_thread_stacks" in "".join(stack)
               for stack in d["threads"].values())
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_install_get_uninstall_and_disable():
    cfg = Config()
    cfg.flight_buffer = 64
    rec = recorder.install(cfg, rank=2)
    try:
        assert recorder.get() is rec and rec.capacity == 64
        cfg.flight_buffer = 0
        assert recorder.install(cfg) is None and recorder.get() is None
    finally:
        recorder.uninstall()
    assert recorder.get() is None


def test_exchanges_record_the_engine_events():
    """An eager all-reduce and a DistributedOptimizer step on the CPU
    record enqueue, dispatch and wire_end, the buckets named after the
    optimizer; the phase totals read their wire time."""
    hvd.init(device="cpu")
    try:
        rec = recorder.get()
        assert rec is not None and recorder.watchdog() is None
        hvd.allreduce(torch.ones(3), name="probe")
        lin = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(lin.parameters(), lr=0.1),
            named_parameters=lin.named_parameters())
        lin(torch.ones(2, 4)).sum().backward()
        opt.step()
        evs = rec.snapshot()
        probe = [(e["ev"], e.get("op")) for e in evs
                 if e.get("name") == "probe"]
        assert probe == [("enqueue", "allreduce"), ("dispatch", "allreduce"),
                         ("wire_end", "allreduce")]
        bucket = [e for e in evs if e.get("name") == "SGD.grads.bucket0"]
        assert [e["ev"] for e in bucket] == ["enqueue", "dispatch",
                                             "wire_end"]
        end = bucket[-1]
        assert end["nbytes"] == 4 * (4 * 2 + 2) and end["span"] >= 0
        assert 0 <= end["wait"] <= end["span"] + 1e-3
        assert rec.phase_totals()["wire_s"] > 0
    finally:
        hvd.shutdown()
    assert recorder.get() is None


def test_watchdog_fully_inert_at_zero_timeout():
    hvd.init(device="cpu")
    try:
        assert recorder.watchdog() is None
        assert not [t for t in threading.enumerate()
                    if t.name == "hvd-diag-watchdog"]
    finally:
        hvd.shutdown()
    cfg = Config()
    cfg.stall_timeout_seconds = 1.0
    assert recorder.start_watchdog(cfg) is None  # no recorder: nothing


def test_watchdog_starts_and_stops_with_the_session(monkeypatch):
    monkeypatch.setenv("HOROVOD_STALL_TIMEOUT_SECONDS", "5")
    hvd.init(device="cpu")
    try:
        wd = recorder.watchdog()
        assert wd is not None and wd.alive and wd.size == 1
        wd._publish_beacon()
        beacon = json.loads(bytes(wd.store.get(wd._key(0))).decode())
        assert beacon["pending"] == [] and beacon["inflight"] == 0
    finally:
        hvd.shutdown()
    assert recorder.watchdog() is None and not wd.alive


def test_late_rank_stall_dumps_and_names_the_missing_rank(tmp_path):
    diag_dir = str(tmp_path / "diag")
    out = spawn_ranks(2, stall_desync, diag_dir, env={
        "HOROVOD_STALL_TIMEOUT_SECONDS": "0.5",
        "HOROVOD_DIAG_DIR": diag_dir}, timeout=90)
    for r in out:
        np.testing.assert_array_equal(r["sum"], np.full(4, 3.0))
    dump, report = out[0]["dump"], out[0]["report"]
    assert dump is not None and dump["reason"] == "stall"
    assert dump["stalled"][0]["name"] == "diag.stall"
    assert dump["stalled"][0]["age_seconds"] >= 0.5  # rounded to ms
    assert any(e["ev"] == "stall_detected" and e["name"] == "diag.stall"
               for e in dump["events"])
    assert report is not None and report["reason"] == "stall"
    st = report["stalled"][0]
    assert (st["name"], st["op"]) == ("diag.stall", "ALLREDUCE")
    assert st["entered"] == [0] and st["missing"] == [1]
    assert report["timeout_seconds"] == 0.5
    # rank 1 entered late but never waited past the timeout
    assert out[1]["dump"] is None


def test_config_diag_knobs_from_env(monkeypatch):
    for knob, value in (("HOROVOD_FLIGHT_BUFFER", "128"),
                        ("HOROVOD_STALL_TIMEOUT_SECONDS", "2.5"),
                        ("HOROVOD_DIAG_DIR", "/tmp/d"),
                        ("HOROVOD_XPROF_STEPS", "4"),
                        ("HOROVOD_PERF_SENTRY", "1"),
                        ("HOROVOD_PERF_SENTRY_THRESHOLD", "0.4"),
                        ("HOROVOD_METRICS_PORT", "0"),
                        ("HOROVOD_METRICS_BIND", "0.0.0.0"),
                        ("HOROVOD_METRICS_INTERVAL", "2.5"),
                        ("HOROVOD_PEAK_FLOPS", "1e15")):
        monkeypatch.setenv(knob, value)
    c, j = Config.from_env(), JaxConfig.from_env()
    for attr in ("flight_buffer", "stall_timeout_seconds", "diag_dir",
                 "xprof_steps", "perf_sentry", "perf_sentry_threshold",
                 "metrics_dir", "metrics_port", "metrics_bind",
                 "metrics_interval", "peak_flops"):
        assert getattr(c, attr) == getattr(j, attr), attr
    assert (c.flight_buffer, c.stall_timeout_seconds, c.xprof_steps) == (
        128, 2.5, 4)
    monkeypatch.setenv("HOROVOD_FLIGHT_BUFFER", "-5")
    monkeypatch.setenv("HOROVOD_XPROF_STEPS", "-1")
    monkeypatch.setenv("HOROVOD_PERF_SENTRY_THRESHOLD", "-1")
    c = Config.from_env()
    assert (c.flight_buffer, c.xprof_steps, c.perf_sentry_threshold) == (
        0, 0, 0.0)


def test_config_defaults_match_the_reference(monkeypatch):
    for knob in ("HOROVOD_FLIGHT_BUFFER", "HOROVOD_STALL_TIMEOUT_SECONDS",
                 "HOROVOD_XPROF_STEPS", "HOROVOD_PERF_SENTRY",
                 "HOROVOD_PERF_SENTRY_THRESHOLD", "HOROVOD_METRICS_DIR",
                 "HOROVOD_METRICS_PORT", "HOROVOD_METRICS_BIND",
                 "HOROVOD_METRICS_INTERVAL"):
        monkeypatch.delenv(knob, raising=False)
    c, j = Config.from_env(), JaxConfig.from_env()
    for attr in ("flight_buffer", "stall_timeout_seconds", "diag_dir",
                 "xprof_steps", "perf_sentry", "perf_sentry_threshold",
                 "metrics_dir", "metrics_port", "metrics_bind",
                 "metrics_interval"):
        assert getattr(c, attr) == getattr(j, attr), attr


def test_config_profiler_path_follows_metrics_then_diag_dir(monkeypatch,
                                                           tmp_path):
    monkeypatch.delenv("HOROVOD_PROFILER_PATH", raising=False)
    monkeypatch.delenv("HOROVOD_METRICS_DIR", raising=False)
    monkeypatch.setenv("HOROVOD_DIAG_DIR", str(tmp_path))
    assert Config.from_env().profiler_path == str(tmp_path / "profiler.txt")
    monkeypatch.setenv("HOROVOD_METRICS_DIR", str(tmp_path / "m"))
    assert Config.from_env().profiler_path == str(
        tmp_path / "m" / "profiler.txt")
    assert Config.from_env().profiler_path \
        == JaxConfig.from_env().profiler_path
    monkeypatch.setenv("HOROVOD_PROFILER_PATH", "/elsewhere/p.txt")
    assert Config.from_env().profiler_path == "/elsewhere/p.txt"
    monkeypatch.delenv("HOROVOD_PROFILER_PATH")
    monkeypatch.delenv("HOROVOD_METRICS_DIR")
    monkeypatch.delenv("HOROVOD_DIAG_DIR")
    assert Config.from_env().profiler_path == "profiler.txt"
