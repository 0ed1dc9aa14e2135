"""The port's coordinator (horovod_tpu_torch/coordinator.py) against the
JAX package's (horovod_tpu/coordinator.py), and its transport over a
``torch.distributed`` store.

Each protocol script drives a pair of coordinators (process 0 and 1)
over one dict-backed KV: the same script through the reference's pair
and the port's, and every decision the processes apply and every key
the KV ends up holding must be the same, byte for byte — the decision
log's replay, its compaction, the epoch-token bypass and its eviction,
the log-driven fast lane, the stall warning, the idle quiesce. The
request wire format (wire.py) and the negotiation
(negotiation.py) are held to the reference's on random metadata. The
adapter over the session's store (utils/store_kv.py) is checked on a
HashStore and a TCPStore, and the steady-state bypass end to end on
two gloo ranks (the engine's tests, test_torch_engine.py).

Behavioral spec: tests/test_coordinator_replay.py.
"""

import datetime
import json
import time

import numpy as np
import pytest
import torch.distributed as dist

from horovod_tpu import coordinator as jcoord
from horovod_tpu import negotiation as jneg
from horovod_tpu import wire as jwire
from horovod_tpu.config import Config as JConfig
from horovod_tpu_torch import coordinator as pcoord
from horovod_tpu_torch import negotiation as pneg
from horovod_tpu_torch import wire as pwire
from horovod_tpu_torch.config import Config as PConfig
from horovod_tpu_torch.exceptions import CoordinatorError
from horovod_tpu_torch.utils.store_kv import StoreKV


class FakeKV:
    """Dict-backed stand-in for the KV surface."""

    def __init__(self):
        self.d = {}
        self.set_calls = 0

    def key_value_set_bytes(self, k, v, allow_overwrite=False):
        self.set_calls += 1
        self.d[k] = bytes(v)

    def key_value_try_get_bytes(self, k):
        return self.d.get(k)

    def blocking_key_value_get_bytes(self, k, timeout_ms):
        if k in self.d:
            return self.d[k]
        raise RuntimeError(f"DEADLINE_EXCEEDED: {k}")

    def key_value_delete(self, k):
        self.d.pop(k, None)


class DeadKV(FakeKV):
    def key_value_set_bytes(self, *a, **kw):
        raise RuntimeError("UNAVAILABLE: failed to connect to all addresses")

    key_value_try_get_bytes = key_value_set_bytes
    blocking_key_value_get_bytes = key_value_set_bytes


def jax_pair(fake, monkeypatch, n=2, **cfg):
    import jax
    jax.process_index()  # init the backend BEFORE the fake client exists
    from jax._src import distributed
    monkeypatch.setattr(distributed.global_state, "client", fake)
    cs = []
    for p in range(n):
        c = jcoord.MultiHostCoordinator(JConfig(**cfg), num_ranks=n,
                                        process_index=p, process_count=n)
        c._ns = "ns"
        cs.append(c)
    return cs


def port_pair(fake, monkeypatch, n=2, **cfg):
    return [pcoord.MultiHostCoordinator(
        PConfig(**cfg), num_ranks=n, client=fake, process_index=p,
        process_count=n, namespace="ns") for p in range(n)]


PAIRS = {"reference": (jax_pair, jneg.RequestMeta, jcoord),
         "port": (port_pair, pneg.RequestMeta, pcoord)}


def _pend(meta, pid, names, seq0, shape=(4,), dtype="float32"):
    return [(seq0 + i, n, meta(rank=pid, op="ALLREDUCE", dtype=dtype,
                               shape=shape))
            for i, n in enumerate(names)]


def _step(cs, meta, names, seq0, **kw):
    for c in cs:
        c.publish(_pend(meta, c.pid, names, seq0, **kw))
    cs[0].coordinate()
    return [c.fetch_decisions(timeout_ms=1) for c in cs]


def script_steady(cs, meta, mod):
    """20 identical cycles: one registration, then replays."""
    out = [_step(cs, meta, [f"g{i}" for i in range(6)], s * 6)
           for s in range(20)]
    return out, (cs[0]._next_deid, cs[1]._known_epochs)


def script_compaction(cs, meta, mod):
    for s in range(150):
        _step(cs, meta, ["t0", "t1"], s * 2)
    return None, (cs[0]._compacted_below, cs[0]._next_decision)


def script_token_crosscheck(cs, meta, mod):
    fake = cs[0]._client
    out = [_step(cs, meta, ["a", "b", "c"], 0),
           _step(cs, meta, ["a", "b", "c"], 3)]
    eid = next(iter(cs[1]._known_epochs.values()))
    fake.key_value_set_bytes("ns/req/1", mod._EPOCH_MAGIC + json.dumps(
        {"e": eid, "s0": 6, "n": 99}).encode())
    cs[0].coordinate()
    out.append(cs[1].fetch_decisions(timeout_ms=1))
    return out, eid in cs[1]._epoch_fp_by_id


def script_eviction(cs, meta, mod):
    seq, out = 0, []
    for s in list(range(8)) + [0]:
        out.append(_step(cs, meta, [f"set{s}.t{i}" for i in range(2)], seq))
        seq += 2
    return out, (len(cs[0]._epochs), sorted(cs[0]._epoch_key_by_id))


def script_fast_lane(cs, meta, mod):
    names = ["fl.a", "fl.b"]
    out = [_step(cs, meta, names, s * 2) for s in range(3)]
    hits = 0
    for k in range(mod._FAST_LANE_REFRESH + 1):
        entries = cs[1].fast_replay_entries(_pend(meta, 1, names,
                                                  6 + 2 * k))
        if entries is None:
            break
        hits += 1
    return out, (hits, bool(cs[1]._fast_assoc))


def script_log_driven(cs, meta, mod):
    names = ["ld.a", "ld.b"]
    for seq0 in (0, 2):
        for c in cs:
            c.publish(_pend(meta, c.pid, names, seq0))
        cs[0].coordinate()
    out = [c.fetch_decisions(timeout_ms=1) for c in cs]
    lane = [c.fast_replay_entries(_pend(meta, c.pid, names, 4))
            for c in cs]
    return out, (cs[0]._applied, cs[1]._applied, lane)


def script_mismatch_and_echo(cs, meta, mod):
    for c, shape in zip(cs, ((2,), (3,))):
        c.publish(_pend(meta, c.pid, ["mm"], 0, shape=shape))
    cs[0].coordinate()
    out = [c.fetch_decisions(timeout_ms=1) for c in cs]
    out.append(_step(cs, meta, ["e.a"], 1, dtype="bfloat16"))
    return out, None


def script_idle(cs, meta, mod):
    fake = cs[0]._client
    cs[1].publish([])
    base = fake.set_calls
    for _ in range(10):
        cs[1].publish([])
    idle = [cs[0].coordinate() for _ in range(3)]
    cs[1].publish(_pend(meta, 1, ["q.a"], 0, shape=(2,)))
    return None, (fake.set_calls - base, idle, cs[0].coordinate())


def script_stall(cs, meta, mod):
    """Process 1 never submits ``st.x``: after the stall window the
    coordinator's second overdue round (the first arms the heartbeat
    read) appends the reference's warning."""
    for c in cs:
        c.config.stall_check_time_seconds = 0.05
    cs[0].publish(_pend(meta, 0, ["st.x"], 0))
    cs[1].publish([])
    cs[0].coordinate()
    time.sleep(0.1)
    cs[0].coordinate()
    cs[0].coordinate()
    return [c.fetch_decisions(timeout_ms=1) for c in cs], None


def script_tree(cs, meta, mod):
    """Five processes, tree fan-in of 2 (HOROVOD_COORD_TREE_FANOUT): the
    group heads batch their groups' blobs into one ``agg`` write each,
    and the root decides from them as from the direct reads."""
    out = []
    for s in range(4):
        for c in cs:
            c.publish(_pend(meta, c.pid, ["t.a", "t.b"], s * 2))
        for c in cs:
            c.aggregate_round()
        cs[0].coordinate()
        out.append([c.fetch_decisions(timeout_ms=1) for c in cs])
    return out, [c._agg_last for c in cs]


def script_graduation(cs, meta, mod):
    """Static-schedule graduation after 3 identical rounds
    (HOROVOD_COORD_GRADUATE_AFTER): the ``grad`` hints, then rounds
    served from the schedule with no publish at all, then the demotion
    a changed set causes."""
    names = ["g.a", "g.b"]
    out = [_step(cs, meta, names, s * 2) for s in range(5)]
    scheduled = [c.fast_replay_entries(_pend(meta, c.pid, names, 10))
                 for c in cs]
    out.append(_step(cs, meta, ["g.c"], 12))
    return out, (scheduled, [dict(c._graduated_local) for c in cs],
                 cs[0]._static_mode)


SCRIPTS = {f.__name__[len("script_"):]: f for f in (
    script_steady, script_compaction, script_token_crosscheck,
    script_eviction, script_fast_lane, script_log_driven,
    script_mismatch_and_echo, script_idle, script_stall, script_tree,
    script_graduation)}
SCRIPT_CONFIG = {"tree": dict(n=5, coord_tree_fanout=2),
                 "graduation": dict(coord_graduate_after=3)}


def _run(which, script, monkeypatch):
    make, meta, mod = PAIRS[which]
    fake = FakeKV()
    if script == "eviction":
        monkeypatch.setattr(mod, "_EPOCH_CAPACITY", 4)
    cs = make(fake, monkeypatch, **SCRIPT_CONFIG.get(script, {}))
    if script == "eviction":
        # the reference's pair learns its size after construction, where
        # the effective capacity (max of the floor and 4 a process) is
        # fixed: the floor, set on both
        for c in cs:
            c._epoch_capacity = 4
    try:
        out, extra = SCRIPTS[script](cs, meta, mod)
    finally:
        for c in cs:
            c.close()
    return out, extra, dict(fake.d)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_protocol_matches_the_reference(monkeypatch, script):
    """Every decision applied and every key left in the KV, byte for
    byte, with the same side effects on the protocol's state."""
    want = _run("reference", script, monkeypatch)
    got = _run("port", script, monkeypatch)
    if script == "stall":
        # the warning is there, in the reference's words, on both sides
        for out in (want, got):
            assert any("\nStalled ranks:\n1: [st.x]" in (d.get("warning")
                                                        or "")
                       for d in out[0][1])
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]


def test_steady_state_ships_replays(monkeypatch):
    out, (deids, known), kv = _run("port", "steady", monkeypatch)
    assert deids == 1 and known
    replays = [d for step in out[1:] for d in step[1] if "replay" in d]
    assert len(replays) == 19
    last = max(int(k.rsplit("/", 1)[1]) for k in kv if "/dec/" in k)
    assert len(kv[f"ns/dec/{last}"]) < 80


def test_compaction_bounds_the_log(monkeypatch):
    _, (below, nxt), kv = _run("port", "compaction", monkeypatch)
    assert nxt >= 150 and below > 0 and "ns/dec/0" not in kv
    assert len([k for k in kv if "/dec/" in k]) <= 3 * pcoord._ACK_EVERY


def test_transport_failures_raise_coordinator_error(monkeypatch):
    c0, c1 = port_pair(FakeKV(), monkeypatch)
    c1._client = DeadKV()
    with pytest.raises(CoordinatorError, match="session's key-value store"):
        for _ in range(pcoord._TRANSPORT_FAIL_LIMIT + 1):
            c1.fetch_decisions(timeout_ms=1)
    c1._transport_failures = 0
    with pytest.raises(CoordinatorError, match="publish"):
        for _ in range(pcoord._TRANSPORT_FAIL_LIMIT + 1):
            c1.publish(_pend(pneg.RequestMeta, 1, ["x"], 0))


@pytest.mark.parametrize("kind", ["hash", "tcp"])
def test_store_adapter_gives_the_coordinators_kv_calls(kind):
    """The four calls on a torch store: set, try-get (None when unset),
    a blocking get whose expiry the coordinator reads as an idle poll,
    delete."""
    store = (dist.HashStore() if kind == "hash" else dist.TCPStore(
        "127.0.0.1", 0, 1, True, timeout=datetime.timedelta(seconds=30)))
    kv = StoreKV(store)
    assert kv.key_value_try_get_bytes("k") is None
    kv.key_value_set_bytes("k", b"\x00v", allow_overwrite=True)
    assert kv.key_value_try_get_bytes("k") == b"\x00v"
    assert kv.blocking_key_value_get_bytes("k", 10) == b"\x00v"
    with pytest.raises(RuntimeError, match="ALREADY_EXISTS"):
        kv.key_value_set_bytes("k", b"w")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as err:
        kv.blocking_key_value_get_bytes("missing", 30)
    assert 0.025 < time.perf_counter() - t0 < 2.0
    assert pcoord._is_timeout_error(err.value)
    kv.key_value_delete("k")
    assert kv.key_value_try_get_bytes("k") is None


def test_coordinators_over_a_store_agree_with_the_fake_kv(monkeypatch):
    """The steady script over a HashStore through the adapter: the same
    decisions as over the dict."""
    fake_out = _run("port", "steady", monkeypatch)[0]
    kv = StoreKV(dist.HashStore())
    cs = [pcoord.MultiHostCoordinator(
        PConfig(), num_ranks=2, client=kv, process_index=p,
        process_count=2, namespace="ns") for p in range(2)]
    out, _ = script_steady(cs, pneg.RequestMeta, pcoord)
    for c in cs:
        c.close()
    assert out == fake_out


def _random_meta(rng, meta, rank, n):
    ops = ["ALLREDUCE", "ALLGATHER", "BROADCAST", "ALLTOALL"]
    dtypes = sorted(pwire.DTYPE_TAGS)
    out = []
    for _ in range(n):
        ndim = int(rng.integers(0, 4))
        out.append(meta(rank=rank, op=ops[int(rng.integers(0, 4))],
                        dtype=dtypes[int(rng.integers(0, len(dtypes)))],
                        shape=tuple(int(d) for d in
                                    rng.integers(1, 9, ndim)),
                        root_rank=int(rng.integers(-1, 3)),
                        average=bool(rng.integers(0, 2))))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_wire_format_matches_the_reference_and_the_native_parser(seed):
    """wire.py writes the reference's bytes and reads them back, as the
    reference's wire.py does (the coordinator's one request-list
    format; the port builds no native parser, csrc/c_api.cc)."""
    rng = np.random.default_rng(seed)
    reqs = _random_meta(rng, pneg.RequestMeta, seed % 3, 12)
    names = [f"{i}|tensor.{seed}.{i}" for i in range(len(reqs))]
    blob = pwire.serialize_request_list(reqs, names, shutdown=seed % 2 == 1)
    jreqs = [jneg.RequestMeta(**r.__dict__) for r in reqs]
    assert blob == jwire.serialize_request_list(jreqs, names,
                                                shutdown=seed % 2 == 1)
    assert pwire.parse_request_list(blob) == (reqs, names, seed % 2 == 1)
    assert jwire.parse_request_list(blob) == (jreqs, names, seed % 2 == 1)


@pytest.mark.parametrize("seed", range(8))
def test_negotiation_matches_the_reference(seed):
    """construct_response on random (often mismatched) requests of 2-4
    ranks: the same response or the same error, word for word."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(50):
        n = int(rng.integers(2, 5))
        base = _random_meta(rng, pneg.RequestMeta, 0, 1)[0]
        reqs = []
        for r in range(n):
            m = dict(base.__dict__, rank=r)
            if rng.random() < 0.3:
                m.update(_random_meta(rng, pneg.RequestMeta, r, 1)[0]
                         .__dict__)
            if base.op == "ALLGATHER" and base.shape and rng.random() < 0.5:
                m["shape"] = (int(rng.integers(1, 9)),) + tuple(
                    m["shape"][1:])
            reqs.append(pneg.RequestMeta(**m))
        got = pneg.construct_response("t", reqs, n)
        want = jneg.construct_response(
            "t", [jneg.RequestMeta(**r.__dict__) for r in reqs], n)
        assert got.__dict__ == want.__dict__


def test_standalone_kv_service_carries_the_protocol(monkeypatch):
    """utils/kvstore.py (the JAX package's standalone server and client,
    kept for a control plane with no process group): the four calls, and
    the steady script over it deciding as over the dict."""
    from horovod_tpu_torch.utils.kvstore import KVClient, KVServer
    server = KVServer()
    try:
        kv = KVClient(f"127.0.0.1:{server.port}")
        assert kv.key_value_try_get_bytes("k") is None
        kv.key_value_set_bytes("k", b"v", allow_overwrite=True)
        assert kv.blocking_key_value_get_bytes("k", 100) == b"v"
        with pytest.raises(RuntimeError) as err:
            kv.blocking_key_value_get_bytes("missing", 20)
        assert pcoord._is_timeout_error(err.value)
        kv.key_value_delete("k")
        assert kv.key_value_try_get_bytes("k") is None
        cs = [pcoord.MultiHostCoordinator(
            PConfig(), num_ranks=2, client=kv, process_index=p,
            process_count=2, namespace="ns") for p in range(2)]
        out, _ = script_steady(cs, pneg.RequestMeta, pcoord)
        for c in cs:
            c.close()
    finally:
        server.close()
    assert out == _run("port", "steady", monkeypatch)[0]
