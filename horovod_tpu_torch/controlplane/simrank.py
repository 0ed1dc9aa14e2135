"""Simulated-rank scale harness: the coordinator protocol at pod scale,
no accelerators required.

Counterpart of horovod_tpu/controlplane/simrank.py, over the port's
coordinator and KV service; the same worlds, modes and round schedules
give the same round digests and executed entry sets.

Hundreds to thousands of lightweight negotiation clients — each a real
:class:`~horovod_tpu_torch.coordinator.MultiHostCoordinator` speaking the real
wire protocol over the real ``utils/kvstore.py`` TCP service — drive
negotiated rounds against a live process-0 coordinator, all multiplexed
onto one host. The harness measures what a real pod would feel:

- **rounds/sec**, both the root's ``coordinate()`` wall time (the
  scaling bottleneck the tree flattens) and honest end-to-end round
  throughput including every member's publish + fetch;
- **decision latency percentiles** (a member's publish to its applied
  decision);
- **per-key KV hot-spot counts** (every client op tallied by key) and
  the root's reads-per-round;
- **graduation behavior**: hit rate, static (wake-probe-only) rounds,
  demotion + re-graduation after an injected membership change.

Modes map to the three points on the scaling curve: ``star`` is the flat O(world)-reads topology,
``tree`` adds ``HOROVOD_COORD_TREE_FANOUT`` aggregation
(controlplane/aggregate.py), ``graduated`` adds static-schedule
graduation (controlplane/schedule.py) on top of the tree. Star and tree
run with the response-cache bypass disabled so every round is a full
negotiation — the honest denominator.

Fidelity notes: members run the exact per-cycle sequence the engine's
``_run_cycle_multihost_locked`` runs (fast_replay_entries, else publish
-> aggregate_round -> coordinate -> fetch_decisions), phased across a
thread pool; after the injected membership change every member performs
one explicit log fetch, standing in for the application cycle's fetch
that consumes the abort in a real job. Coordinators share one KV fan-out
pool (a thousand private 64-thread pools would measure the OS, not the
protocol) and clients RST-close their one-shot connections so the
harness does not exhaust ephemeral ports against TIME_WAIT.

CLI::

    python -m horovod_tpu_torch.controlplane.simrank --world 256 --mode tree
    python -m horovod_tpu_torch.controlplane.simrank --curve --json CTRL.json
    python -m horovod_tpu_torch.controlplane.simrank --smoke   # CI gate
"""

import argparse
import concurrent.futures
import hashlib
import json
import sys
import threading
import time

from .. import metrics
from ..config import Config
from ..coordinator import MultiHostCoordinator
from ..negotiation import ALLREDUCE, RequestMeta, participant_digest
from ..utils.kvstore import KVClient, KVServer

MODES = ("star", "tree", "graduated")

# Default tree fanout for the harness: sqrt-ish of the largest world, so
# root reads are O(fanout + world/fanout) ~ 64 at world 1024.
DEFAULT_FANOUT = 32

DEFAULT_GRADUATE_AFTER = 3


class KVTally:
    """Thread-safe per-key op counts — the hot-spot ledger."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_key = {}
        self.total = 0

    def count(self, key):
        with self._lock:
            self._by_key[key] = self._by_key.get(key, 0) + 1
            self.total += 1

    def hottest(self, n=10):
        with self._lock:
            items = sorted(self._by_key.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return items[:n]


class CountingKV:
    """Wraps a KVClient with per-key op tallies plus a local read
    counter (the root's delta around ``coordinate()`` is its
    reads-per-round). Same four-method surface the coordinator uses, so
    ``safe_kv_client`` passes it through untouched."""

    def __init__(self, inner, tally):
        self._inner = inner
        self._tally = tally
        self._lock = threading.Lock()
        self.reads = 0

    def _read(self, key):
        self._tally.count(key)
        with self._lock:
            self.reads += 1

    def key_value_set_bytes(self, key, value, allow_overwrite=False):
        self._tally.count(key)
        return self._inner.key_value_set_bytes(
            key, value, allow_overwrite=allow_overwrite)

    def blocking_key_value_get_bytes(self, key, timeout_in_ms):
        self._read(key)
        return self._inner.blocking_key_value_get_bytes(key, timeout_in_ms)

    def key_value_try_get_bytes(self, key):
        self._read(key)
        return self._inner.key_value_try_get_bytes(key)

    def key_value_delete(self, key):
        self._tally.count(key)
        return self._inner.key_value_delete(key)


def _percentile(values, q):
    if not values:
        return None
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
    return vs[idx]


def _entries_digest(entries):
    """Canonical digest of one round's executed tensor entries — the
    unit of the bit-identity check (schedule.py docstring)."""
    canon = sorted((json.dumps(e, sort_keys=True) for e in entries))
    h = hashlib.sha1()
    for line in canon:
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


class SimMember:
    """One simulated rank: a real coordinator over an injected KV client
    (no device, no process group), running the engine's multi-host
    cycle shape."""

    def __init__(self, pid, world, config, addr, ns, tally, kv_pool,
                 n_tensors):
        self.pid = pid
        client = CountingKV(
            KVClient(addr, rst_close=True, retries=2,
                     retry_base_seconds=0.05), tally)
        self.client = client
        self.coord = MultiHostCoordinator(
            config, num_ranks=world, client=client,
            process_index=pid, process_count=world,
            namespace=ns)              # one shared session namespace
        self.coord._pool = kv_pool     # one shared fan-out pool
        self.metas = [
            (f"t{i}", RequestMeta(rank=pid, op=ALLREDUCE, dtype="float32",
                                  shape=(32, 8)))
            for i in range(n_tensors)]
        self.n_tensors = n_tensors
        # Measurement state
        self.exec_seq = []             # digests of executed entry sets
        self.replay_count = 0
        self.cycle_count = 0
        self.negotiate_latencies = []  # publish -> decision applied (s)
        self._t_publish = None
        self._stream = hashlib.sha1()  # digest over applied decisions
        self._applied_count = 0

    def pending(self, rnd):
        base = rnd * self.n_tensors
        return [(base + i, name, meta)
                for i, (name, meta) in enumerate(self.metas)]

    def cycle(self, rnd):
        """fast-replay-or-publish — the front half of the engine's
        multi-host cycle. Returns True when this member published (and
        therefore must run ``finish`` after the root's round)."""
        self.cycle_count += 1
        pending = self.pending(rnd)
        t0 = time.perf_counter()
        entries = self.coord.fast_replay_entries(pending)
        if entries is not None:
            self.replay_count += 1
            self.exec_seq.append(_entries_digest(entries))
            return False
        self._t_publish = t0
        self.coord.publish(pending)
        return True

    def finish(self, timeout_ms=5000):
        """Consume the decision log — the back half of the cycle."""
        decisions = self.coord.fetch_decisions(timeout_ms=timeout_ms)
        entries = []
        for d in decisions:
            self._stream.update(
                json.dumps(d, sort_keys=True).encode() + b"\n")
            self._applied_count += 1
            entries.extend(d.get("tensors") or ())
        if entries:
            self.exec_seq.append(_entries_digest(entries))
            if self._t_publish is not None:
                self.negotiate_latencies.append(
                    time.perf_counter() - self._t_publish)
        self._t_publish = None
        return decisions

    def stream_digest(self):
        return self._applied_count, self._stream.hexdigest()


class SimWorld:
    """A whole simulated pod over one live KV service."""

    def __init__(self, world, mode, fanout=DEFAULT_FANOUT,
                 graduate_after=DEFAULT_GRADUATE_AFTER, n_tensors=4,
                 workers=32):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.world = world
        self.mode = mode
        self.fanout = fanout if mode in ("tree", "graduated") else 0
        config = Config()
        # Star/tree measure FULL negotiation every round; graduation
        # works with the bypass disabled too (coordinator._graduate_locked)
        # so the graduated mode isolates the schedule win from the
        # response-cache fast lane.
        config.coordinator_bypass_disable = True
        config.coord_tree_fanout = self.fanout
        config.coord_graduate_after = (
            graduate_after if mode == "graduated" else 0)
        self.graduate_after = config.coord_graduate_after
        self.config = config
        self.server = KVServer(backlog=512)
        addr = f"127.0.0.1:{self.server.port}"
        self.tally = KVTally()
        self.kv_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="simrank-kv")
        self.driver_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="simrank-drv")
        ns = "hvdtpu/sim"
        self.members = [
            SimMember(p, world, config, addr, ns, self.tally,
                      self.kv_pool, n_tensors)
            for p in range(world)]
        self.root = self.members[0]
        if self.fanout >= 2 and world > self.fanout:
            from . import aggregate as _tree
            heads = set(_tree.group_heads(range(world), self.fanout))
            self.heads = [m for m in self.members if m.pid in heads]
        else:
            self.heads = []
        # Per-round records
        self.coordinate_walls = []
        self.root_reads = []
        self.published_per_round = []
        self.round_digests = []       # participant_digest of submissions

    def _map(self, fn, items):
        return list(self.driver_pool.map(fn, items))

    def run_round(self, rnd):
        published = self._map(lambda m: m.cycle(rnd), self.members)
        pubs = [m for m, p in zip(self.members, published) if p]
        if pubs:
            self.round_digests.append(participant_digest(
                {m.pid: [(name, meta) for name, meta in m.metas]
                 for m in pubs}))
        if self.heads and pubs:
            self._map(lambda m: m.coord.aggregate_round(), self.heads)
        reads0 = self.root.client.reads
        t0 = time.perf_counter()
        self.root.coord.coordinate()
        self.coordinate_walls.append(time.perf_counter() - t0)
        self.root_reads.append(self.root.client.reads - reads0)
        if pubs:
            self._map(lambda m: m.finish(), pubs)
        self.published_per_round.append(len(pubs))

    def inject_membership_change(self):
        """Mid-run membership change: the cooperative hosts-updated
        abort a real elastic rendezvous appends. Every graduated
        schedule must demote; no decision may be lost or mismatched.
        The explicit fetch below stands in for the application cycle
        that consumes the abort in a real job (each member re-raises it
        as HostsUpdatedError there)."""
        self.root.coord.announce_hosts_updated()
        self._map(lambda m: m.finish(timeout_ms=1000), self.members)

    def drain(self):
        self._map(lambda m: m.finish(timeout_ms=200), self.members)

    def verify_streams(self):
        """Zero lost / mismatched decisions: every member applied the
        same number of decisions with the same content digest."""
        digests = {m.stream_digest() for m in self.members}
        return len(digests) == 1, sorted(digests)

    def close(self):
        self.driver_pool.shutdown(wait=True)
        self.kv_pool.shutdown(wait=True)
        self.server.close()
        try:
            metrics.registry().remove_collect_hook("coordinator")
        except Exception:  # noqa: BLE001 — hygiene only
            pass


def run_mode(world, mode, rounds, fanout=DEFAULT_FANOUT,
             graduate_after=DEFAULT_GRADUATE_AFTER, inject_at=None,
             workers=32):
    """Drive one (world, mode) cell and return its measurements."""
    sim = SimWorld(world, mode, fanout=fanout,
                   graduate_after=graduate_after, workers=workers)
    try:
        t_start = time.perf_counter()
        for rnd in range(rounds):
            if inject_at is not None and rnd == inject_at:
                sim.inject_membership_change()
            sim.run_round(rnd)
        wall = time.perf_counter() - t_start
        sim.drain()
        streams_ok, _ = sim.verify_streams()

        coord_wall = sum(sim.coordinate_walls)
        lat = [v for m in sim.members for v in m.negotiate_latencies]
        total_cycles = sum(m.cycle_count for m in sim.members)
        replays = sum(m.replay_count for m in sim.members)
        # Steady state: rounds after the first fully-replayed round,
        # excluding the re-graduation warmup after an injection (the
        # demotion round plus the K-round streak rebuild).
        warmup = max(2, sim.graduate_after)
        first_steady = next(
            (i for i, n in enumerate(sim.published_per_round) if n == 0),
            None)
        if first_steady is not None:
            window = [i for i in range(first_steady, rounds)
                      if not (inject_at is not None
                              and inject_at <= i < inject_at + warmup)]
            hits = sum(world - sim.published_per_round[i] for i in window)
            hit_rate = hits / (world * len(window)) if window else None
        else:
            hit_rate = 0.0 if mode == "graduated" else None
        steady_reads = (sim.root_reads[first_steady]
                        if first_steady is not None else None)
        demoted = regraduated = None
        if inject_at is not None:
            post = sim.published_per_round[inject_at:]
            demoted = any(n == world for n in post)
            regraduated = any(n == 0 for n in post)
        result = {
            "world": world,
            "mode": mode,
            "fanout": sim.fanout,
            "rounds": rounds,
            "tensors_per_rank": sim.members[0].n_tensors,
            "coordinator_rounds_per_sec": (
                rounds / coord_wall if coord_wall > 0 else None),
            "end_to_end_rounds_per_sec": rounds / wall if wall > 0 else None,
            "decision_latency_ms": {
                "p50": _ms(_percentile(lat, 0.50)),
                "p95": _ms(_percentile(lat, 0.95)),
                "p99": _ms(_percentile(lat, 0.99)),
                "samples": len(lat),
            },
            "root_reads_per_round": {
                "first": sim.root_reads[0] if sim.root_reads else None,
                "steady": steady_reads,
                "mean": (sum(sim.root_reads) / len(sim.root_reads)
                         if sim.root_reads else None),
            },
            "kv_ops_total": sim.tally.total,
            "hot_keys": sim.tally.hottest(10),
            "decision_streams_identical": streams_ok,
        }
        if mode == "graduated":
            result["graduation"] = {
                "graduate_after": sim.graduate_after,
                "hit_rate": hit_rate,
                "replayed_cycles": replays,
                "total_cycles": total_cycles,
                "static_root_reads": steady_reads,
            }
        if inject_at is not None:
            result["membership_change"] = {
                "injected_round": inject_at,
                "all_demoted": demoted,
                "regraduated": regraduated,
                "decision_streams_identical": streams_ok,
            }
        result["exec_seqs"] = {m.pid: list(m.exec_seq)
                               for m in sim.members}
        result["round_input_digests"] = list(sim.round_digests)
        return result
    finally:
        sim.close()


def _ms(v):
    return None if v is None else round(v * 1000.0, 3)


def bit_identity_check(world, rounds, fanout=DEFAULT_FANOUT,
                       inject_at=None, workers=32):
    """Paired-world check: identical submissions with graduation off
    (star, full negotiation) vs on must execute byte-identical tensor
    entry sets, member for member, round for round."""
    off = run_mode(world, "star", rounds, fanout=fanout,
                   inject_at=inject_at, workers=workers)
    on = run_mode(world, "graduated", rounds, fanout=fanout,
                  inject_at=inject_at, workers=workers)
    identical = all(
        off["exec_seqs"][p] == on["exec_seqs"][p] for p in range(world))
    inputs_identical = (off["round_input_digests"][0]
                        == on["round_input_digests"][0])
    return {
        "world": world,
        "rounds": rounds,
        "executed_entries_identical": identical,
        "round_inputs_identical": inputs_identical,
        "off_streams_identical": off["decision_streams_identical"],
        "on_streams_identical": on["decision_streams_identical"],
    }


def _strip(result):
    """Drop the bulky per-member sequences before publishing JSON."""
    out = dict(result)
    out.pop("exec_seqs", None)
    out.pop("round_input_digests", None)
    return out


def scaling_curve(worlds=(8, 64, 256, 1024), fanout=DEFAULT_FANOUT,
                  workers=32, rounds=None):
    """The published curve: star vs tree vs graduated across worlds,
    plus a bit-identity pairing and a membership-change injection.
    ``rounds``: the star's and the tree's rounds in every world (default
    30 up to world 64, 20 up to 256, 12 beyond); the graduated mode runs
    the rounds its graduation and injection need."""
    cells = []
    for world in worlds:
        n = rounds or (30 if world <= 64 else (20 if world <= 256 else 12))
        grounds = DEFAULT_GRADUATE_AFTER + 17
        inject = DEFAULT_GRADUATE_AFTER + 8
        row = {"world": world}
        for mode in MODES:
            if mode == "graduated":
                r = run_mode(world, mode, grounds, fanout=fanout,
                             inject_at=inject, workers=workers)
            else:
                r = run_mode(world, mode, n, fanout=fanout,
                             workers=workers)
            row[mode] = _strip(r)
        star = row["star"]["coordinator_rounds_per_sec"]
        tree = row["tree"]["coordinator_rounds_per_sec"]
        row["tree_speedup_over_star"] = (
            round(tree / star, 2) if star and tree else None)
        cells.append(row)
    identity = bit_identity_check(
        min(64, max(worlds)), DEFAULT_GRADUATE_AFTER + 9,
        fanout=fanout, inject_at=DEFAULT_GRADUATE_AFTER + 5,
        workers=workers)
    top = cells[-1]
    acceptance = {
        "largest_world": top["world"],
        "tree_speedup_over_star": top["tree_speedup_over_star"],
        "tree_speedup_ok": (top["tree_speedup_over_star"] or 0) >= 4.0,
        "graduated_static_root_reads":
            top["graduated"]["root_reads_per_round"]["steady"],
        "graduated_o1_reads_ok":
            top["graduated"]["root_reads_per_round"]["steady"] == 1,
        "decisions_bit_identical":
            identity["executed_entries_identical"],
        "demotion_on_membership_change":
            top["graduated"]["membership_change"]["all_demoted"],
    }
    return {"worlds": list(worlds), "fanout": fanout, "cells": cells,
            "bit_identity": identity, "acceptance": acceptance}


def smoke(world=256, fanout=16, workers=16):
    """CI gate: one graduated world with a mid-run membership change,
    self-asserting the acceptance floors and ceilings. Returns (ok,
    report)."""
    rounds = DEFAULT_GRADUATE_AFTER + 17
    inject = DEFAULT_GRADUATE_AFTER + 8
    r = run_mode(world, "graduated", rounds, fanout=fanout,
                 inject_at=inject, workers=workers)
    checks = {
        # Floors/ceilings are deliberately loose — a loaded 1-CPU CI
        # runner must pass, a regression to O(world) static rounds or
        # lost decisions must not.
        "rounds_per_sec_floor": (
            (r["end_to_end_rounds_per_sec"] or 0) >= 1.0),
        "coordinator_rounds_per_sec_floor": (
            (r["coordinator_rounds_per_sec"] or 0) >= 10.0),
        "decision_latency_p99_ceiling": (
            (r["decision_latency_ms"]["p99"] or 1e9) <= 2500.0),
        "graduation_hit_rate": (
            (r["graduation"]["hit_rate"] or 0) >= 0.9),
        "static_root_reads_o1": (
            r["root_reads_per_round"]["steady"] == 1),
        "no_lost_or_mismatched_decisions": (
            r["decision_streams_identical"]
            and r["membership_change"]["decision_streams_identical"]),
        "demoted_then_regraduated": (
            r["membership_change"]["all_demoted"]
            and r["membership_change"]["regraduated"]),
    }
    report = {"world": world, "fanout": fanout, "rounds": rounds,
              "result": _strip(r), "checks": checks,
              "ok": all(checks.values())}
    return report["ok"], report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="horovod_tpu_torch control-plane scale harness "
                    "(simulated ranks over the real KV protocol)")
    ap.add_argument("--world", type=int, default=64)
    ap.add_argument("--mode", choices=MODES, default="star")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--fanout", type=int, default=DEFAULT_FANOUT)
    ap.add_argument("--graduate-after", type=int,
                    default=DEFAULT_GRADUATE_AFTER)
    ap.add_argument("--inject-at", type=int, default=None,
                    help="inject a membership change before this round")
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--json", default=None,
                    help="write the result JSON to this path")
    ap.add_argument("--curve", action="store_true",
                    help="run the full scaling curve (overrides --world)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke: 256 simulated ranks, self-asserting")
    args = ap.parse_args(argv)

    if args.smoke:
        ok, report = smoke()
        out = report
    elif args.curve:
        out = scaling_curve(fanout=args.fanout, workers=args.workers)
        ok = True
    else:
        out = _strip(run_mode(
            args.world, args.mode, args.rounds, fanout=args.fanout,
            graduate_after=args.graduate_after, inject_at=args.inject_at,
            workers=args.workers))
        ok = out["decision_streams_identical"]
    out["command"] = ("python -m horovod_tpu_torch.controlplane.simrank "
                      + " ".join(argv if argv is not None
                                 else sys.argv[1:]))
    text = json.dumps(out, indent=2, sort_keys=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
