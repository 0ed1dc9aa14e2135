"""The port's control plane (horovod_tpu_torch/controlplane/) against the
JAX package's: the stale-head fallback of the tree fan-in
(``HeadReceiptClock``, ``fallback_members`` and the coordinator's
elastic tree round) and the simulated-rank harness (``simrank``).

The harness worlds are real coordinators over one real KV server
(utils/kvstore.py), in one process, as ``simrank`` runs them; worlds
stay at or below 16 so that the file runs in well under a minute. The
round digests of the port's ``SimWorld`` are held to the JAX
``SimWorld``'s at the same world, mode and seed (the submissions are a
function of the round, so "seed" is the round schedule).

Behavioral spec: tests/test_controlplane.py.
"""

import logging
import time

import pytest

from horovod_tpu.controlplane import simrank as jsim
from horovod_tpu.negotiation import participant_digest as jdigest
from horovod_tpu.negotiation import RequestMeta as JMeta
from horovod_tpu_torch import metrics
from horovod_tpu_torch.config import Config
from horovod_tpu_torch.controlplane import aggregate
from horovod_tpu_torch.controlplane import simrank as psim
from horovod_tpu_torch.coordinator import MultiHostCoordinator
from horovod_tpu_torch.negotiation import (ALLGATHER, ALLREDUCE, RequestMeta,
                                           participant_digest)
from horovod_tpu_torch.utils.kvstore import KVClient, KVServer
from horovod_tpu_torch.utils.logging import get_logger


# ---------------------------------------------------------------------------
# aggregate.py: the receipt clock and the fallback set


def test_head_receipt_clock_staleness():
    c = aggregate.HeadReceiptClock(stale_after=5.0)
    c.note(4, b"blob-a", now=0.0)
    assert c.stale([4], now=4.0) == set()
    assert c.stale([4], now=5.1) == {4}
    # a changed blob restores full credit (the head recovered)
    c.note(4, b"blob-b", now=6.0)
    assert c.stale([4], now=10.0) == set()
    # re-observing the same frozen blob restores nothing
    c.note(4, b"blob-b", now=10.0)
    assert c.stale([4], now=11.5) == {4}


def test_head_receipt_clock_startup_grace():
    c = aggregate.HeadReceiptClock(stale_after=5.0)
    # a head never observed gets twice the window from the first ask
    assert c.stale([8], now=100.0) == set()
    assert c.stale([8], now=109.0) == set()
    assert c.stale([8], now=110.1) == {8}
    # forget() drops the history: a rejoining pid starts with fresh credit
    c.forget(8)
    assert c.stale([8], now=200.0) == set()


def test_fallback_members_full_group_with_head():
    groups = aggregate.tree_groups(range(9), 3)  # [0-2] [3-5] [6-8]
    assert aggregate.fallback_members(groups, {3}) == [3, 4, 5]
    assert aggregate.fallback_members(groups, {3, 6}) == [3, 4, 5,
                                                          6, 7, 8]
    assert aggregate.fallback_members(groups, set()) == []
    # the root's own group always reads direct, never a fallback target
    assert aggregate.fallback_members(groups, {0}) == []
    assert aggregate.group_heads(range(9), 3) == [3, 6]
    assert aggregate.children_of(6, range(9), 3) == [6, 7, 8]
    assert aggregate.children_of(7, range(9), 3) == []


def test_aggregate_matches_the_reference_format():
    from horovod_tpu.controlplane import aggregate as jagg
    entries = [("R", 3, b"req"), ("L", 4, b"17"), ("B", 5, b"1")]
    assert aggregate.pack_entries(entries) == jagg.pack_entries(entries)
    assert aggregate.unpack_entries(jagg.pack_entries(entries)) == entries


# ---------------------------------------------------------------------------
# the stale-head fallback in the coordinator's elastic tree round


class _StaleWorld:
    """Six in-process coordinators over one KV server in elastic tree
    mode at fanout 2: groups [0, 1], [2, 3], [4, 5]; heads 2 and 4."""

    def __init__(self, n=6, fanout=2, timeout=2.0):
        cfg = Config()
        cfg.elastic = True
        cfg.elastic_timeout_seconds = timeout
        cfg.coord_tree_fanout = fanout
        cfg.coordinator_bypass_disable = True
        self.server = KVServer()
        addr = f"127.0.0.1:{self.server.port}"
        self.coords = [
            MultiHostCoordinator(
                cfg, n, client=KVClient(addr, rst_close=True),
                process_index=p, process_count=n, namespace="hvd/stale")
            for p in range(n)]
        self.root = self.coords[0]
        self.heads = [c for c in self.coords
                      if c.pid in aggregate.group_heads(range(n), fanout)]
        self.frozen = set()
        self.decided = {}  # name -> time the root's log held it

    def round(self, name, seq):
        for c in self.coords:
            c.publish_liveness()
            c.publish([(seq, name, RequestMeta(
                rank=c.pid, op=ALLREDUCE, dtype="float32", shape=(4,)))])
        for h in self.heads:
            if h.pid not in self.frozen:
                h.aggregate_round()
        self.root.elastic_round()
        self.root.coordinate()
        for d in self.root.fetch_decisions(timeout_ms=20):
            for t in d.get("tensors") or ():
                self.decided.setdefault(t["name"], time.perf_counter())
        for c in self.coords[1:]:
            c.fetch_decisions(timeout_ms=0)

    def close(self):
        for c in self.coords:
            c.close()
        self.server.close()


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_a_stale_head_has_its_group_read_directly():
    """A head that stops sweeping has its group (head included) read
    directly within ``stale_after`` (half the elastic timeout), with
    ``hvd_ctrl_stale_agg_heads`` set, and goes back to tree reads once
    its blob moves again. Before the repair, the group's requests were
    never decided (the loop below ran out its 3 x ``stale_after``)."""
    w = _StaleWorld()
    stale_after = 0.5 * w.root.config.elastic_timeout_seconds
    log = get_logger()
    lines = _Lines()
    level = log.level
    log.addHandler(lines)
    log.setLevel(logging.INFO)
    try:
        for seq in range(2):
            w.round(f"t{seq}", seq)
        assert {"t0", "t1"} <= set(w.decided)
        assert metrics.CTRL_STALE_HEADS.value() == 0
        # head 2 stops sweeping; its members (2 and 3) keep publishing
        # requests and liveness
        w.frozen.add(2)
        t_freeze = time.perf_counter()
        deadline = t_freeze + 3 * stale_after
        longest = 0.0
        while "t2" not in w.decided and time.perf_counter() < deadline:
            t0 = time.perf_counter()
            w.round("t2", 2)
            longest = max(longest, time.perf_counter() - t0)
            time.sleep(0.02)
        assert "t2" in w.decided, (
            f"the stale head's group was not read directly within "
            f"{3 * stale_after:.1f}s")
        # the clock runs from the blob's last change (the last sweep
        # before the freeze), which the root saw; it is read once a
        # round, so the decision may trail the window by a round or two
        changed = w.root._head_clock._seen[2][1]
        assert changed <= t_freeze
        took = w.decided["t2"] - changed
        assert took <= stale_after + 2 * longest + 0.05, (took, longest)
        assert metrics.CTRL_STALE_HEADS.value() == 1
        assert any("aggregator head 2 stale" in m for m in lines.lines)
        # no process was declared lost: the members kept beating
        assert not w.root._lost_pids
        # the head sweeps again: its blob moves, the root reads it again
        w.frozen.clear()
        for seq in (3, 4):
            w.round(f"t{seq}", seq)
            time.sleep(0.02)
        assert metrics.CTRL_STALE_HEADS.value() == 0
        assert any("aggregator head 2 recovered" in m for m in lines.lines)
        assert {"t3", "t4"} <= set(w.decided)
    finally:
        log.removeHandler(lines)
        log.setLevel(level)
        w.close()


# ---------------------------------------------------------------------------
# negotiation.participant_digest


def _reqs_by_rank(mod, world, n_tensors, order=1):
    out = {}
    for rank in range(world):
        items = [(f"t{i}", mod(rank=rank, op=ALLREDUCE, dtype="float32",
                               shape=(32, 8))) for i in range(n_tensors)]
        out[rank] = items[::order]
    return out


def test_participant_digest_matches_the_reference():
    a = _reqs_by_rank(RequestMeta, 64, 4)
    b = _reqs_by_rank(RequestMeta, 64, 4, order=-1)
    b = {r: b[r] for r in sorted(b, reverse=True)}
    assert participant_digest(a) == participant_digest(b)
    assert participant_digest(a) == jdigest(_reqs_by_rank(JMeta, 64, 4))
    c = _reqs_by_rank(RequestMeta, 64, 4)
    c[7] = [(n, RequestMeta(rank=7, op=ALLGATHER, dtype=m.dtype,
                            shape=m.shape)) for n, m in c[7]]
    assert participant_digest(a) != participant_digest(c)


# ---------------------------------------------------------------------------
# simrank.py: the harness worlds


class _DictKV:
    def __init__(self):
        self.d = {}

    def key_value_set_bytes(self, key, value, allow_overwrite=False):
        self.d[key] = bytes(value)

    def blocking_key_value_get_bytes(self, key, timeout_in_ms):
        return self.d[key]

    def key_value_try_get_bytes(self, key):
        return self.d.get(key)

    def key_value_delete(self, key):
        self.d.pop(key, None)


def test_counting_kv_tallies_reads():
    tally = psim.KVTally()
    kv = psim.CountingKV(_DictKV(), tally)
    kv.key_value_set_bytes("a", b"1")
    kv.key_value_set_bytes("b", b"2")
    for _ in range(3):
        assert kv.key_value_try_get_bytes("a") == b"1"
    assert kv.blocking_key_value_get_bytes("b", 100) == b"2"
    assert kv.key_value_try_get_bytes("missing") is None
    assert kv.reads == 5
    hot = dict(tally.hottest(2))
    assert hot["a"] == 4 and hot["b"] == 2


def test_sim_star_small_world():
    r = psim.run_mode(6, "star", rounds=5, workers=6)
    assert r["decision_streams_identical"]
    assert r["coordinator_rounds_per_sec"] > 0
    assert r["root_reads_per_round"]["first"] >= 6
    assert all(len(s) == 5 for s in r["exec_seqs"].values())


def test_sim_tree_decisions_match_star():
    star = psim.run_mode(9, "star", rounds=4, workers=9)
    tree = psim.run_mode(9, "tree", rounds=4, fanout=3, workers=9)
    assert tree["decision_streams_identical"]
    for p in range(9):
        assert star["exec_seqs"][p] == tree["exec_seqs"][p]
    assert (star["round_input_digests"][0]
            == tree["round_input_digests"][0])
    assert (tree["root_reads_per_round"]["mean"]
            < star["root_reads_per_round"]["mean"])


def test_sim_graduated_static_rounds_and_demotion():
    r = psim.run_mode(6, "graduated", rounds=14, fanout=3, graduate_after=2,
                      inject_at=7, workers=6)
    assert r["decision_streams_identical"]
    g = r["graduation"]
    assert g["hit_rate"] > 0.5
    assert g["static_root_reads"] == 1
    m = r["membership_change"]
    assert m["all_demoted"], "membership change must demote everyone"
    assert m["regraduated"], "steady state must re-graduate after churn"
    assert m["decision_streams_identical"]


def test_sim_bit_identity_graduation_on_vs_off():
    out = psim.bit_identity_check(5, rounds=8, fanout=3, inject_at=4,
                                  workers=5)
    assert out["executed_entries_identical"]
    assert out["round_inputs_identical"]
    assert out["off_streams_identical"] and out["on_streams_identical"]


@pytest.mark.parametrize("mode,world,fanout", [
    ("star", 8, 0), ("tree", 9, 3), ("graduated", 8, 4)])
def test_sim_round_digests_match_the_reference(mode, world, fanout):
    """The same world, mode and round schedule through the port's
    harness and the JAX package's: identical round input digests,
    executed entry sets member for member, and root reads a round."""
    kw = dict(fanout=fanout or psim.DEFAULT_FANOUT, workers=world)
    if mode == "graduated":
        kw.update(graduate_after=2, inject_at=6)
    p = psim.run_mode(world, mode, 10, **kw)
    j = jsim.run_mode(world, mode, 10, **kw)
    assert p["round_input_digests"] == j["round_input_digests"]
    assert p["exec_seqs"] == j["exec_seqs"]
    assert p["root_reads_per_round"] == j["root_reads_per_round"]
    assert p["decision_streams_identical"] and j["decision_streams_identical"]


def test_simrank_smoke_cli_at_a_small_world(tmp_path, capsys):
    out = tmp_path / "ctrl.json"
    code = psim.main(["--world", "8", "--mode", "tree", "--fanout", "4",
                      "--rounds", "4", "--workers", "8",
                      "--json", str(out)])
    assert code == 0
    import json
    r = json.loads(out.read_text())
    assert r["world"] == 8 and r["mode"] == "tree"
    assert r["command"].startswith(
        "python -m horovod_tpu_torch.controlplane.simrank")
