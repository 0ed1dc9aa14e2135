"""Per-rank collective flight recorder and hang watchdog.

Counterpart of horovod_tpu/diag/recorder.py. The recorder, its
snapshot, phase totals, dump format and process-wide installation are
the JAX package's, so either package's CLI reads either package's
dumps:

- **Always on, off the critical path.** ``FlightRecorder.record`` is one
  GIL-atomic counter increment (``itertools.count``), two clock reads and
  one tuple store into a preallocated ring — no locks, no allocation
  beyond the tuple, safe from any thread (the gradient hooks run on
  autograd's device thread).
- **Bounded memory.** The ring holds ``HOROVOD_FLIGHT_BUFFER`` entries
  (default 4096, rounded up to a power of two); older events are
  overwritten, like an aircraft flight recorder.
- **Crash-durable on demand.** ``dump()`` writes ``flight-rank<N>.json``
  (ring + all-thread Python stacks + progress marks) atomically.
- **Inert by default.** The watchdog thread and its progress beacons
  exist only when ``HOROVOD_STALL_TIMEOUT_SECONDS > 0``; the recorder
  itself can be disabled with ``HOROVOD_FLIGHT_BUFFER=0``.

The port's collectives (ops/collectives.py ``Exchange``) record the JAX
engine's events: ``enqueue`` when an exchange is made, ``dispatch`` at
each launch, ``wire_end`` with its ``span`` and ``wait`` when it is
done. On a card the span is known only when the exchange's end event
has completed: ``wire_end`` is recorded when stats.py's pending queue
resolves it, and the step is never synchronised to get it. A
collective captured into a CUDA graph records nothing per replay.

The watchdog (:class:`HangWatchdog`) watches the port's own exchanges:
one is in flight from its first launch until the device has finished
it (its works report completion, and on a card its end event has
completed), polled without blocking. Its beacons go through the
runtime's store (``runtime.py``'s ``TCPStore`` or ``HashStore``) under
a per-session namespace.

Event tuples are ``(seq, t_mono, t_wall, event, name, op, nbytes, dtype,
extra)`` — monotonic (``perf_counter``) for intra-rank spans, wall clock
for cross-rank alignment in the ``python -m horovod_tpu_torch.diag``
merger.
"""

import itertools
import json
import os
import sys
import threading
import time
import traceback

from .. import metrics
from ..utils.logging import get_logger

_logger = get_logger()

DUMP_VERSION = 1


def _pow2_at_least(n):
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length() if n & (n - 1) else n


class FlightRecorder:
    """Lock-free bounded ring of collective lifecycle events. Writers
    serialize through the atomic itertools.count() ticket and each slot
    store is a single GIL-atomic list assignment; readers (dump,
    snapshot) tolerate torn windows by design. Only the dump, which
    touches the filesystem, takes ``_dump_lock``."""

    def __init__(self, capacity=4096, rank=0, process_index=0, digest="",
                 diag_dir=""):
        cap = _pow2_at_least(capacity or 1)
        self._ring = [None] * cap
        self._mask = cap - 1
        self._count = itertools.count()
        self.capacity = cap
        self.rank = int(rank)
        self.process_index = int(process_index)
        self.digest = digest
        self.diag_dir = diag_dir or ""
        # Progress marks for the watchdog beacons: plain attribute stores
        # (GIL-atomic), set by the coordinator as it applies decisions and
        # by the engine's multi-process cycle.
        self.last_decision_index = -1
        self.last_cycle_wall = 0.0
        self._dump_lock = threading.Lock()

    # ------------------------------------------------------------- hot path

    def record(self, ev, name="", op="", nbytes=0, dtype="", extra=None):
        """Append one lifecycle event. Hot-path safe: no locks, no I/O."""
        i = next(self._count)
        self._ring[i & self._mask] = (i, time.perf_counter(), time.time(),
                                      ev, name, op, nbytes, dtype, extra)

    @property
    def events_recorded(self):
        """Total events ever recorded (monotonic; ring holds the tail)."""
        # itertools.count has no peek; stash-and-restore would race.
        # Track via the newest ring slot instead (None ring = 0 events).
        newest = -1
        for e in self._ring:
            if e is not None and e[0] > newest:
                newest = e[0]
        return newest + 1

    # ------------------------------------------------------------ snapshots

    def snapshot(self):
        """Ring contents as ordered event dicts (oldest first)."""
        entries = [e for e in self._ring if e is not None]
        entries.sort(key=lambda e: e[0])
        out = []
        for seq, t_mono, t_wall, ev, name, op, nbytes, dtype, extra in entries:
            d = {"seq": seq, "t": round(t_mono, 6), "wall": round(t_wall, 6),
                 "ev": ev}
            if name:
                d["name"] = name
            if op:
                d["op"] = op
            if nbytes:
                d["nbytes"] = int(nbytes)
            if dtype:
                d["dtype"] = dtype
            if extra:
                d.update(extra)
            out.append(d)
        return out

    def phase_totals(self):
        """Aggregate phase attribution over the current ring: wire span,
        exposed readback wait, input wait, step wall time. The basis of
        bench/resnet.py's ``flight_step_phase_breakdown`` and the
        TelemetryCallback phase gauges (``hvd_diag_phase_seconds``).
        Scans the ring off the hot path; events older than the ring are
        gone (bounded memory)."""
        wire = readback = input_w = step_s = 0.0
        steps = 0
        for e in self._ring:
            if e is None:
                continue
            ev, extra = e[3], e[8]
            if not extra:
                continue
            if ev == "wire_end":
                wire += extra.get("span", 0.0)
                readback += extra.get("wait", 0.0)
            elif ev == "input_wait":
                input_w += extra.get("wait", 0.0)
            elif ev == "step":
                step_s += extra.get("dt", 0.0)
                steps += 1
        return {"wire_s": wire, "readback_s": readback, "input_s": input_w,
                "step_s": step_s, "steps": steps,
                "events": self.events_recorded}

    # ----------------------------------------------------------------- dump

    def dump_path(self):
        return os.path.join(self.diag_dir or ".",
                            f"flight-rank{self.rank}.json")

    def dump(self, path=None, reason="manual", extra=None):
        """Durable post-mortem: ring + all-thread stacks + progress marks,
        written atomically. Returns the path, or None on failure (a dump
        must never take the job down with it)."""
        path = path or self.dump_path()
        payload = {
            "version": DUMP_VERSION,
            "reason": reason,
            "rank": self.rank,
            "pid": self.process_index,
            "wall_at_dump": time.time(),
            "mono_at_dump": time.perf_counter(),
            "membership_digest": self.digest,
            "last_decision_index": self.last_decision_index,
            "last_cycle_wall": self.last_cycle_wall,
            "events": self.snapshot(),
            "threads": _thread_stacks(),
        }
        if extra:
            payload.update(extra)
        try:
            with self._dump_lock:
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(payload, f, default=str)
                os.replace(tmp, path)
        except OSError as e:
            _logger.warning("flight recorder dump to %s failed: %s", path, e)
            return None
        metrics.DIAG_DUMPS.inc()
        _logger.warning("flight recorder dump (%s): %s", reason, path)
        return path


def _thread_stacks():
    """All-thread Python stacks, keyed by thread name (the post-mortem's
    'where was everyone' section)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'unknown')}-{ident}"
        out[label] = [ln.rstrip() for ln in traceback.format_stack(frame)]
    return out


# ------------------------------------------------- process-wide installation

_recorder = None
_recorder_config = None


def install(config, rank=0, process_index=0, digest=""):
    """Create (or replace) the process recorder from config. Returns None —
    recorder disabled — when ``HOROVOD_FLIGHT_BUFFER`` is 0."""
    global _recorder, _recorder_config
    _recorder_config = config
    if int(getattr(config, "flight_buffer", 4096)) <= 0:
        _recorder = None
        metrics.registry().remove_collect_hook("diag")
        return None
    _recorder = FlightRecorder(capacity=config.flight_buffer, rank=rank,
                               process_index=process_index, digest=digest,
                               diag_dir=getattr(config, "diag_dir", ""))
    rec = _recorder
    metrics.registry().set_collect_hook(
        "diag", lambda: metrics.DIAG_EVENTS.set(rec.events_recorded))
    return _recorder


def get():
    """The process recorder, or None when disabled / pre-init."""
    return _recorder


def uninstall():
    global _recorder, _recorder_config
    _recorder = None
    _recorder_config = None
    metrics.registry().remove_collect_hook("diag")


def _diag_active(config):
    """Whether automatic post-mortems are wanted: an explicit diag dir or
    a live stall timeout. Keeps ordinary runs (tests, local notebooks)
    from littering the CWD with dump files while still recording in
    memory."""
    return bool(getattr(config, "diag_dir", "")
                or float(getattr(config, "stall_timeout_seconds", 0)) > 0)


def dump_post_mortem(reason, extra=None, force=False):
    """Automatic dump hook for abort paths: dump the process recorder
    when diagnostics are active (the JAX package calls it from its
    elastic and guard paths, which the port does not have yet).
    ``force=True`` dumps whenever a recorder exists, even with no diag
    dir or stall timeout configured. Never raises."""
    rec, cfg = _recorder, _recorder_config
    if rec is None or cfg is None or (not force and not _diag_active(cfg)):
        return None
    # diag_dir may have changed since install() (a re-init rebuilds the
    # config; tests toggle it): honor the live value, not the captured one
    rec.diag_dir = getattr(cfg, "diag_dir", rec.diag_dir)
    try:
        return rec.dump(reason=reason, extra=extra)
    except Exception:  # noqa: BLE001 — post-mortems must never kill work
        _logger.debug("post-mortem dump failed", exc_info=True)
        return None


# ---------------------------------------------------------------- watchdog

_watchdog = None


def watchdog():
    """The live hang watchdog, or None (the knob's default)."""
    return _watchdog


def start_watchdog(config, store=None, rank=0, size=1, namespace="hvd"):
    """Create + start the hang watchdog, or None when
    ``HOROVOD_STALL_TIMEOUT_SECONDS`` is 0 (fully inert: no thread, no
    beacons). ``store`` is the session's ``torch.distributed`` store,
    where the beacons go under ``namespace``."""
    global _watchdog
    timeout = float(getattr(config, "stall_timeout_seconds", 0))
    if timeout <= 0 or _recorder is None:
        return None
    wd = HangWatchdog(_recorder, config, store, rank, size, namespace)
    wd.start()
    _watchdog = wd
    return wd


def stop_watchdog():
    """Stop and drop the live watchdog, if any."""
    global _watchdog
    wd, _watchdog = _watchdog, None
    if wd is not None:
        wd.stop()


class HangWatchdog:
    """Background hang detector: any exchange in flight (launched, and
    not finished on the device) past ``stall_timeout_seconds`` triggers
    a durable flight dump; ranks publish ``(last_decision_index,
    last_cycle)`` progress beacons, with the names of their exchanges
    in flight, through the session's store, so process 0 can name
    exactly which ranks entered the stalled collective and which are
    missing (the desync report, ``desync-report.json``)."""

    BEACON_KIND = "diag"

    def __init__(self, recorder, config, store=None, rank=0, size=1,
                 namespace="hvd"):
        self.recorder = recorder
        self.timeout = float(config.stall_timeout_seconds)
        self.diag_dir = getattr(config, "diag_dir", "") or ""
        self.store = store
        self.rank = int(rank)
        self.size = int(size)
        self.namespace = namespace
        self._inflight = {}      # id -> exchange, added at its first launch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd-diag-watchdog", daemon=True)
        self._reported = set()   # stalled names already dumped this episode

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)

    @property
    def alive(self):
        return self._thread.is_alive()

    def track(self, exchange):
        """Watch ``exchange`` (ops/collectives.py ``Exchange``: ``name``,
        ``op``, ``t_dispatch`` and a non-blocking ``in_flight()``) until
        the device has finished it. A plain dict store: GIL-atomic."""
        self._inflight[id(exchange)] = exchange

    # ------------------------------------------------------------ main loop

    def _interval(self):
        return min(max(self.timeout / 4.0, 0.05), 1.0)

    def _loop(self):
        while not self._stop.wait(self._interval()):
            try:
                self._publish_beacon()
                stalled = self._find_stalled()
                if stalled:
                    self._report(stalled)
                elif self._reported:
                    self._reported.clear()  # recovered: re-arm
            except Exception:  # noqa: BLE001 — the watchdog must survive
                _logger.debug("watchdog tick failed", exc_info=True)

    # ------------------------------------------------------------- beacons

    def _pending(self):
        """Names of this rank's exchanges still in flight; finished ones
        leave the table. Polls only: never waits on the device."""
        out = []
        for key, ex in list(self._inflight.items()):
            if ex.in_flight():
                out.append(ex.name or ex.op)
            else:
                self._inflight.pop(key, None)
        return out

    def _beacon_payload(self):
        pending = self._pending()
        rec = self.recorder
        return {"di": rec.last_decision_index,
                "cy": rec.last_cycle_wall,
                "pending": pending[:64],
                "inflight": len(pending),
                "t": time.time()}

    def _key(self, rank):
        return f"{self.namespace}/{self.BEACON_KIND}/{rank}"

    def _publish_beacon(self):
        if self.store is None:
            return
        try:
            self.store.set(self._key(self.rank),
                           json.dumps(self._beacon_payload()))
        except Exception:  # noqa: BLE001 — best-effort beacon
            pass

    def _peer_beacons(self):
        """{rank: beacon} for every rank of the session (best-effort; a
        key not yet written is skipped, never waited for)."""
        if self.store is None or self.size <= 1:
            return {self.rank: self._beacon_payload()}
        out = {}
        for p in range(self.size):
            if p == self.rank:
                out[p] = self._beacon_payload()
                continue
            try:
                if self.store.check([self._key(p)]):
                    out[p] = json.loads(bytes(
                        self.store.get(self._key(p))).decode())
            except Exception:  # noqa: BLE001 — a dead peer has no beacon
                pass
        return out

    # ------------------------------------------------------ stall detection

    def _find_stalled(self):
        """[(name, op, age_seconds, local_missing_ranks)] for exchanges
        in flight past the timeout."""
        now = time.perf_counter()
        stalled = []
        for key, ex in list(self._inflight.items()):
            if not ex.in_flight():
                self._inflight.pop(key, None)
                continue
            age = now - ex.t_dispatch
            if age > self.timeout:
                stalled.append((ex.name or ex.op, ex.op.upper(), age, []))
        return stalled

    def _report(self, stalled):
        fresh = [s for s in stalled if s[0] not in self._reported]
        if not fresh:
            return
        for name, _, _, _ in fresh:
            self._reported.add(name)
        metrics.DIAG_STALLS.inc(len(fresh))
        beacons = self._peer_beacons()
        info = {"stalled": [{"name": n, "op": op,
                             "age_seconds": round(age, 3),
                             "missing_local_ranks": missing}
                            for n, op, age, missing in fresh],
                "beacons": {str(p): b for p, b in beacons.items()}}
        self.recorder.record(
            "stall_detected", fresh[0][0], fresh[0][1],
            extra={"age": round(fresh[0][2], 3),
                   "n_stalled": len(fresh)})
        self.recorder.dump(
            os.path.join(self.diag_dir or ".",
                         f"flight-rank{self.recorder.rank}.json"),
            reason="stall", extra=info)
        if self.rank == 0:
            self._write_desync_report(fresh, beacons)

    def _write_desync_report(self, stalled, beacons):
        """Process 0 only: name exactly which ranks entered each stalled
        collective and which are missing. Membership comes from the
        progress beacons (a rank that entered lists the name as pending:
        it is waiting inside the collective); at one rank the entered set
        is this rank."""
        multihost = self.store is not None and self.size > 1
        report = {"version": DUMP_VERSION, "reason": "stall",
                  "wall": time.time(), "timeout_seconds": self.timeout,
                  "pid": self.recorder.process_index,
                  "stalled": [], "beacons": {str(p): b
                                             for p, b in beacons.items()}}
        total_missing = 0
        for name, op, age, local_missing in stalled:
            if multihost:
                entered = sorted(p for p, b in beacons.items()
                                 if name in b.get("pending", ()))
                known = sorted(beacons)
                missing = [p for p in known if p not in entered]
                # A peer so wedged (or dead) it never published a beacon
                # is missing by definition.
                missing += [p for p in range(self.size) if p not in known]
            else:
                entered = [self.rank]
                missing = local_missing
            total_missing = max(total_missing, len(missing))
            decision_index = {str(p): b.get("di", -1)
                              for p, b in beacons.items()}
            report["stalled"].append(
                {"name": name, "op": op, "age_seconds": round(age, 3),
                 "entered": entered, "missing": sorted(missing),
                 "decision_index": decision_index})
            _logger.error(
                "desync: collective %r stalled %.1fs past the %.1fs "
                "timeout at decision index %s; entered: %s; MISSING: %s "
                "(flight dumps + desync-report.json in %s)",
                name, age, self.timeout,
                self.recorder.last_decision_index, entered, sorted(missing),
                self.diag_dir or os.getcwd())
        metrics.DIAG_DESYNC_MISSING.set(total_missing)
        path = os.path.join(self.diag_dir or ".", "desync-report.json")
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(report, f, default=str)
            os.replace(tmp, path)
        except OSError as e:
            _logger.warning("desync report write failed: %s", e)
