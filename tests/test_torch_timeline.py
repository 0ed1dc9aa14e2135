"""The port's timeline (horovod_tpu_torch/timeline.py, ``HOROVOD_TIMELINE``)
against the JAX package's, end to end through the eager engine.

One rank writes through the native writer (csrc/timeline.cc); two gloo
ranks write one trace, rank 0's, into which rank 1's collected events
are spliced at shutdown (the reference's rank-0 writer,
timeline.h:46-74). The same operations through the JAX engine
(``hvd.init(num_ranks=2)``, every rank submitted in this process) give
each tensor's row the same sequence of events: negotiation, the op,
its activities.

Behavioral spec: tests/test_timeline_e2e.py.
"""

import json

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu_torch import timeline as ptimeline
from torch_engine_workers import timeline_session
from torch_ranks import spawn_ranks

SCRIPT = [
    {"kind": "allreduce", "order": {0: ["tl.ar", "tl.ar2"],
                                    1: ["tl.ar2", "tl.ar"]},
     "items": {"tl.ar": {"data": {r: np.full(4, float(r), np.float32)
                                  for r in range(2)},
                         "kw": {"average": False}},
               "tl.ar2": {"data": {r: np.ones(3, np.float32)
                                   for r in range(2)}}}},
    {"kind": "allgather", "order": {0: ["tl.ag"], 1: ["tl.ag"]},
     "items": {"tl.ag": {"data": {0: np.ones((2, 2), np.float32),
                                  1: np.ones((3, 2), np.float32)}}}},
    {"kind": "broadcast", "order": {0: ["tl.bc"], 1: ["tl.bc"]},
     "items": {"tl.bc": {"data": {r: np.ones(3, np.float32)
                                  for r in range(2)},
                         "kw": {"root_rank": 1}}}},
]


def _rows(events, remote=False):
    """{tensor name: [(ph, name, tid)]} of a trace's tensor rows: the
    local ones, or those spliced in from another process."""
    names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            label = e["args"]["name"]
            if (":" in label) == remote:
                names[e["pid"]] = label.split(":", 1)[-1]
    out = {}
    for e in events:
        if e.get("pid") in names and e.get("ph") in ("B", "E"):
            out.setdefault(names[e["pid"]], []).append(
                (e["ph"], e.get("name"), e.get("tid")))
    return out


def _load(path):
    return [e for e in json.loads(path.read_text()) if e]


def test_one_rank_native_writer_end_to_end(tmp_path, monkeypatch):
    """test_timeline_e2e.py's assertions through the native writer."""
    path = tmp_path / "timeline.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    hvd.init(device="cpu")
    try:
        assert isinstance(hvd.runtime.live_state().timeline,
                          ptimeline.NativeTimeline)
        hvd.allreduce(torch.ones(4), average=False, name="tl.ar")
        hvd.allgather(torch.ones(2, 2), name="tl.ag")
        hvd.broadcast(torch.ones(3), root_rank=0, name="tl.bc")
    finally:
        hvd.shutdown()
    events = _load(path)
    names = {e.get("name") for e in events}
    for want in ("NEGOTIATE_ALLREDUCE", "ALLREDUCE", "CYCLE_START",
                 "NEGOTIATE_ALLGATHER", "ALLGATHER", "NEGOTIATE_BROADCAST",
                 "BROADCAST", "MEMCPY_IN_FUSION_BUFFER",
                 "MEMCPY_OUT_FUSION_BUFFER", "XLA_ALLREDUCE"):
        assert want in names, want
    rows = {e["args"]["name"] for e in events if e.get("ph") == "M"}
    assert {"tl.ar", "tl.ag", "tl.bc"} <= rows


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("tl") / "timeline.json"
    spawn_ranks(2, timeline_session, str(path), SCRIPT,
                env={"HOROVOD_TPU_TICKER_DISABLE": "1"})
    return _load(path)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    from test_torch_engine import run_reference_script
    path = tmp_path_factory.mktemp("jtl") / "timeline.json"
    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_TIMELINE", str(path))
    jhvd.shutdown()
    jhvd.init(num_ranks=2)
    try:
        run_reference_script(SCRIPT)
    finally:
        jhvd.shutdown()
        mp.undo()
    return _load(path)


@pytest.mark.parametrize("name", ["tl.ar", "tl.ar2", "tl.ag", "tl.bc"])
def test_event_sequence_matches_the_reference(two_ranks, reference, name):
    assert _rows(two_ranks)[name] == _rows(reference)[name]


def test_the_other_ranks_events_are_spliced_into_rank_zeros_file(
        two_ranks):
    local, remote = _rows(two_ranks), _rows(two_ranks, remote=True)
    assert set(local) == set(remote) == {"tl.ar", "tl.ar2", "tl.ag",
                                         "tl.bc"}
    for name in local:
        assert remote[name] == local[name]
