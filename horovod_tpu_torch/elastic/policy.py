"""Traffic-driven autoscaling policy: decide when the elastic world
should grow or shrink, from the live telemetry the workers already
export.

Counterpart of horovod_tpu/elastic/policy.py, copied (plain Python):
the signal files, their reading, compaction and fold, and the policy's
decisions are the JAX package's for the same inputs. The launcher that
acts on them is run/run.py (``launch_elastic(autoscale=True)``).

No 0.16 reference analog — the reference's world size is fixed at
mpirun time, and even v0.20 Elastic Horovod only *reacts* to external
membership changes (its discovery script is user-supplied). This module
closes the loop: the same signals the metrics families carry — straggler skew (``hvd_step_time_skew``), input
stall ratio (``hvd_data_stall_ratio``), prefetch-queue occupancy
(``hvd_data_prefetch_occupancy``) — feed a supervisor-side policy that
emits scale decisions, bounded by ``--min-workers``/``--max-workers``.

Signal transport is a file drop, not RPC: each worker's
:class:`~horovod_tpu_torch.callbacks.TelemetryCallback` writes a small JSON
blob (``signals-{rank}.json``) into ``HOROVOD_ELASTIC_POLICY_DIR`` at a
throttled cadence, and the supervisor polls the directory between
child-process waits. Files survive worker death (the last signal of a
dying straggler is exactly what the policy wants to see) and cost the
training loop nothing measurable.

Flap resistance is structural, not tuned: a decision needs
``hysteresis`` CONSECUTIVE observations of the same condition, and any
executed resize opens a ``cooldown_seconds`` window during which the
policy holds regardless of signals. Restart-budget exhaustion is the
one exception — the slot is already gone, so the scale-down decision
merely formalizes a fact and bypasses both filters
(docs/troubleshooting.md covers diagnosing a flapping policy).
"""

import glob
import json
import os
import time


def write_signal(policy_dir, rank, payload):
    """Atomically drop one worker's signal file (tmp + rename so the
    supervisor never reads a torn write). Best-effort by design — a
    missed signal only delays the policy one interval."""
    path = os.path.join(policy_dir, f"signals-{rank}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def read_signals(policy_dir, max_age=30.0, now=None, prune_after=None):
    """Per-rank signal dicts fresher than ``max_age`` seconds.

    Files merely past ``max_age`` are skipped, not deleted — a worker
    mid-restart will overwrite its own. But a file stale past
    ``prune_after`` seconds (default ``10 * max_age``) is UNLINKED: its
    writer is long gone (a drained victim, a shrunk world, a renamed
    serve task), and without pruning a long-lived autoscaling
    deployment accretes one dead file per departed reporter forever —
    every poll then pays a stat+parse per tombstone. Unlink races with
    a writer are harmless: ``write_signal`` replaces atomically, so the
    worst case is one freshly-rewritten signal arriving next poll.

    Aggregated bundles (``signals-agg-*.json``, see
    :func:`write_signal_bundle`) expand in place: each carries many
    reporters' dicts in one file read. Per-reporter freshness still
    applies, and the freshest dict wins for a rank that appears both
    standalone and in a bundle (or in two bundles).
    """
    now = time.time() if now is None else now
    if prune_after is None:
        prune_after = 10.0 * max_age
    prune_after = max(float(prune_after), float(max_age))
    best = {}      # dedupe key -> (signal time, dict)
    unkeyed = []   # signals with neither rank nor tag: keep them all
    for path in sorted(glob.glob(os.path.join(policy_dir,
                                              "signals-*.json"))):
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, ValueError):
            continue
        signals = d.get("bundle") if isinstance(d, dict) else None
        if signals is None:
            signals = [d]
        elif not isinstance(signals, list):
            continue
        fresh = False
        for s in signals:
            if not isinstance(s, dict):
                continue
            t = float(s.get("time", 0) or 0)
            if now - t > max_age:
                continue
            fresh = True
            key = s.get("rank", s.get("tag"))
            if key is None:
                unkeyed.append((t, s))
            elif key not in best or t > best[key][0]:
                best[key] = (t, s)
        if not fresh:
            newest = max((float(s.get("time", 0) or 0)
                          for s in signals if isinstance(s, dict)),
                         default=0.0)
            if now - newest > prune_after:
                try:
                    os.unlink(path)
                except OSError:
                    pass
    out = [s for _, s in best.values()] + [s for _, s in unkeyed]
    out.sort(key=lambda s: (str(s.get("rank", "")), str(s.get("tag", ""))))
    return out


def write_signal_bundle(policy_dir, tag, signals):
    """Atomically drop one aggregated bundle (``signals-agg-{tag}.json``)
    carrying many reporters' dicts — the file-drop analog of the
    coordinator's tree fan-in (controlplane/aggregate.py): the
    supervisor's poll then costs O(bundles) file reads instead of
    O(world). Best-effort like :func:`write_signal`."""
    path = os.path.join(policy_dir, f"signals-agg-{tag}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump({"bundle": list(signals)}, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def compact_signals(policy_dir, tag="0", max_age=30.0, now=None,
                    keep_fresh_standalone=True):
    """Supervisor-side fan-in: fold every fresh standalone signal file
    into one bundle and unlink the originals, so steady-state polls read
    O(1) files no matter the world size. ``keep_fresh_standalone=False``
    also folds files younger than ``max_age``; the default only compacts
    what a poll would read anyway. Returns the number of files folded."""
    now = time.time() if now is None else now
    folded = []
    paths = []
    for path in sorted(glob.glob(os.path.join(policy_dir,
                                              "signals-*.json"))):
        if os.path.basename(path).startswith("signals-agg-"):
            continue
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(d, dict):
            continue
        if keep_fresh_standalone and now - float(d.get("time", 0) or 0) \
                > max_age:
            continue
        folded.append(d)
        paths.append(path)
    if not folded:
        return 0
    # Merge with the bundle's previous contents so a reporter that went
    # quiet since the last compaction is not forgotten prematurely
    # (freshness filtering happens at read time, pruning at prune_after).
    bundle_path = os.path.join(policy_dir, f"signals-agg-{tag}.json")
    try:
        with open(bundle_path) as f:
            prior = json.load(f).get("bundle", [])
    except (OSError, ValueError):
        prior = []
    best = {}
    unkeyed = []
    for s in list(prior) + folded:
        if not isinstance(s, dict):
            continue
        key = s.get("rank", s.get("tag"))
        t = float(s.get("time", 0) or 0)
        if key is None:
            unkeyed.append(s)
        elif key not in best or t > best[key][0]:
            best[key] = (t, s)
    write_signal_bundle(policy_dir, tag,
                        [s for _, s in best.values()] + unkeyed)
    for path in paths:
        try:
            os.unlink(path)
        except OSError:
            pass
    return len(paths)


def _int_rank(s):
    """A signal's integer rank, or None — serve-side signals
    (serve/api.py) carry no rank (their filename tag is "serveN") and
    must neither crash the fold nor become drain victims."""
    try:
        return int(s.get("rank"))
    except (TypeError, ValueError):
        return None


def aggregate_signals(signals):
    """Fold per-rank signal dicts into the policy's view: worst-case
    skew, mean stall/occupancy (system-wide properties), the furthest
    step any rank reported, and the slowest non-coordinator rank (the
    natural drain victim). Signals missing training fields fold as
    neutral (a serve-only dict contributes nothing to skew/stall);
    the optional serving fields ``queue_depth`` and ``p99_latency``
    fold as worst-case across reporters, None when nobody carries
    them — the SLO-elasticity inputs (docs/serving.md).
    ``exchange_hidden_frac`` (the bucketed backward/exchange overlap
    measured by the last trace capture, docs/observability.md) also
    folds worst-case — min across reporters, since one rank with an
    exposed wire paces the whole gang; None until somebody traced."""
    agg = {"reporting": len(signals), "skew": 1.0, "stall": 0.0,
           "occupancy": None, "max_step": 0, "slowest_rank": None,
           "queue_depth": None, "p99_latency": None,
           "exchange_hidden_frac": None}
    if not signals:
        return agg
    agg["skew"] = max(float(s.get("skew", 1.0) or 1.0) for s in signals)
    stalls = [float(s.get("stall", 0.0) or 0.0) for s in signals]
    agg["stall"] = sum(stalls) / len(stalls)
    occs = [float(s["occupancy"]) for s in signals
            if s.get("occupancy") is not None]
    agg["occupancy"] = sum(occs) / len(occs) if occs else None
    agg["max_step"] = max(int(s.get("step", 0) or 0) for s in signals)
    queues = [float(s["queue_depth"]) for s in signals
              if s.get("queue_depth") is not None]
    agg["queue_depth"] = max(queues) if queues else None
    p99s = [float(s["p99_latency"]) for s in signals
            if s.get("p99_latency") is not None]
    agg["p99_latency"] = max(p99s) if p99s else None
    hidden = [float(s["exchange_hidden_frac"]) for s in signals
              if s.get("exchange_hidden_frac") is not None]
    agg["exchange_hidden_frac"] = min(hidden) if hidden else None
    slow = None
    for s in signals:
        r = _int_rank(s)
        if r is None or r == 0:
            # rank 0 hosts the coordination service and rank-less
            # (serve) reporters hold no drainable train slot: never
            # pick either as the victim.
            continue
        st = float(s.get("step_seconds", 0.0) or 0.0)
        if slow is None or st > slow[1]:
            slow = (r, st)
    agg["slowest_rank"] = slow[0] if slow else None
    return agg


class ScaleDecision:
    """One policy verdict: ``direction`` in {"up", "down", "hold"},
    the ``target`` world size, a human-readable ``reason``, and — for
    drains — the ``victim_rank`` the supervisor should SIGTERM."""

    __slots__ = ("direction", "target", "reason", "victim_rank")

    def __init__(self, direction, target, reason, victim_rank=None):
        self.direction = direction
        self.target = int(target)
        self.reason = reason
        self.victim_rank = victim_rank

    def __repr__(self):
        return (f"ScaleDecision({self.direction!r}, target={self.target}, "
                f"reason={self.reason!r}, victim={self.victim_rank})")


class AutoscalePolicy:
    """Hysteresis-and-cooldown gated scale policy over aggregated
    worker signals.

    Rules (each evaluated per :meth:`observe` call):

    - **scale down** when straggler skew stays >= ``skew_high`` (drain
      the slowest rank — the whole gang runs at its pace anyway), or
      when the mean input-stall ratio stays >= ``stall_high`` (the job
      is input-bound: fewer consumers raise each survivor's share of
      input bandwidth instead of burning accelerator-hours waiting);
    - **scale up** when prefetch-queue occupancy stays >=
      ``occupancy_high`` of the queue depth while stall stays low (the
      producers are comfortably ahead — the job is compute-bound and
      more workers convert directly into throughput);
    - **scale up** (serving) when the folded serve signals breach the
      SLO: p99 per-token latency >= ``p99_high`` or admission-queue
      depth >= ``queue_high``. Both thresholds default to None
      (inert) so training-only deployments are untouched; serve
      reporters carry no rank and are never drain victims
      (docs/serving.md "SLO-driven elasticity");
    - **scale down immediately** when the supervisor reports a worker's
      restart budget exhausted (``budget_exhausted=True``): the
      capacity is already gone, so the decision records it instead of
      letting the job silently run degraded.

    A condition must hold for ``hysteresis`` consecutive observations,
    and no decision (budget exhaustion aside) fires within
    ``cooldown_seconds`` of the last executed resize
    (:meth:`record_resize`). Targets clamp to
    [``min_workers``, ``max_workers``].
    """

    def __init__(self, min_workers=1, max_workers=None, skew_high=1.5,
                 stall_high=0.5, occupancy_high=0.9, hysteresis=3,
                 cooldown_seconds=30.0, queue_high=None, p99_high=None):
        self.min_workers = max(int(min_workers), 1)
        self.max_workers = int(max_workers) if max_workers else None
        self.skew_high = float(skew_high)
        self.stall_high = float(stall_high)
        self.occupancy_high = float(occupancy_high)
        # Serving SLO thresholds (docs/serving.md "SLO-driven
        # elasticity"): inert at None — a training-only deployment
        # never sees serve signals and keeps its exact behavior.
        self.queue_high = float(queue_high) if queue_high else None
        self.p99_high = float(p99_high) if p99_high else None
        self.hysteresis = max(int(hysteresis), 1)
        self.cooldown_seconds = float(cooldown_seconds)
        self._streak = {"up": 0, "down": 0}
        self._last_resize_t = None

    def record_resize(self, now=None):
        """The launcher executed a resize: open the cooldown window and
        clear the streaks (post-resize signals describe a new world)."""
        self._last_resize_t = time.time() if now is None else now
        self._streak = {"up": 0, "down": 0}

    def _cooling(self, now):
        return (self._last_resize_t is not None
                and now - self._last_resize_t < self.cooldown_seconds)

    def _clamp(self, target):
        target = max(target, self.min_workers)
        if self.max_workers is not None:
            target = min(target, self.max_workers)
        return target

    def observe(self, signals, world, now=None, budget_exhausted=False):
        """One policy tick over ``signals`` (per-rank dicts, see
        :func:`read_signals`) at current ``world`` size. Returns a
        :class:`ScaleDecision` (direction "hold" when nothing fires)."""
        now = time.time() if now is None else now
        world = int(world)
        if budget_exhausted and world - 1 >= self.min_workers:
            # Not a judgment call: the slot is unrecoverable. Bypasses
            # hysteresis and cooldown; formalizes the shrink so it is
            # counted, logged, and LR-rescaled like any other resize.
            return ScaleDecision(
                "down", world - 1,
                "restart budget exhausted: retiring the slot as a "
                "scale-down instead of a silent stall")
        agg = aggregate_signals(signals)
        want_down = None
        if agg["reporting"]:
            if agg["skew"] >= self.skew_high:
                want_down = (f"straggler skew {agg['skew']:.2f} >= "
                             f"{self.skew_high:.2f}")
            elif agg["stall"] >= self.stall_high:
                want_down = (f"input stall ratio {agg['stall']:.2f} >= "
                             f"{self.stall_high:.2f} (input-bound)")
        want_up = None
        if (agg["reporting"] and agg["occupancy"] is not None
                and agg["occupancy"] >= self.occupancy_high
                and agg["stall"] < self.stall_high):
            want_up = (f"prefetch occupancy {agg['occupancy']:.2f} >= "
                       f"{self.occupancy_high:.2f} with low stall "
                       f"(compute-bound)")
        if (want_up is None and self.p99_high is not None
                and agg["p99_latency"] is not None
                and agg["p99_latency"] >= self.p99_high):
            want_up = (f"serve p99 latency {agg['p99_latency']:.3f}s >= "
                       f"SLO {self.p99_high:.3f}s")
        if (want_up is None and self.queue_high is not None
                and agg["queue_depth"] is not None
                and agg["queue_depth"] >= self.queue_high):
            want_up = (f"serve queue depth {agg['queue_depth']:.0f} >= "
                       f"{self.queue_high:.0f}")
        if self._cooling(now):
            # Streaks do not accumulate while cooling: after the window
            # the condition must re-prove itself for a full hysteresis
            # run against the resized world's signals.
            self._streak = {"up": 0, "down": 0}
            return ScaleDecision("hold", world, "cooldown after resize")
        self._streak["down"] = self._streak["down"] + 1 if want_down else 0
        self._streak["up"] = self._streak["up"] + 1 if want_up else 0
        if want_down and self._streak["down"] >= self.hysteresis:
            target = self._clamp(world - 1)
            if target < world:
                return ScaleDecision("down", target, want_down,
                                     victim_rank=agg["slowest_rank"])
            return ScaleDecision("hold", world,
                                 f"{want_down}, but already at "
                                 f"--min-workers={self.min_workers}")
        if want_up and self._streak["up"] >= self.hysteresis:
            target = self._clamp(world + 1)
            if target > world:
                return ScaleDecision("up", target, want_up)
            return ScaleDecision("hold", world,
                                 f"{want_up}, but already at "
                                 f"--max-workers={self.max_workers}")
        return ScaleDecision("hold", world, "no condition past hysteresis")
