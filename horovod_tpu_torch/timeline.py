"""Chrome-tracing timeline of collective negotiation and execution.

Counterpart of horovod_tpu/timeline.py (``HOROVOD_TIMELINE``,
``HOROVOD_TIMELINE_MARK_CYCLES``). The native writer
(:class:`NativeTimeline`, horovod_tpu_torch/csrc/timeline.cc) writes a
one-process job's trace; a job of several ranks uses the Python writer
(:class:`Timeline`), rank 0 writing the one file into which the other
ranks' collected events are spliced at shutdown. The eager engine's
wire activity is named ``XLA_*`` as in the JAX package, so a trace
reader of either package reads both.

Reference equivalent: horovod/common/timeline.{h,cc} — rank 0 writes a Chrome
about:tracing JSON where each tensor name is a "process" row, moving through
states NEGOTIATING → TOP_LEVEL(op) → ACTIVITY (e.g. MEMCPY_IN_FUSION_BUFFER,
MPI_ALLREDUCE; activity name constants in horovod/common/common.h:31-55), with
an async writer thread fed through a lock-free queue (timeline.h:46-74) and
optional cycle markers (``HOROVOD_TIMELINE_MARK_CYCLES``, timeline.h:97).

Here the writer is a daemon thread draining a queue.SimpleQueue (the CPython
equivalent of the SPSC lockfree queue), emitting the same event structure:
Chrome "B"/"E" duration events per tensor row plus instant events for cycle
markers. Activity names are kept identical so trace-reading tooling carries
over.
"""

import json
import queue
import threading
import time

from .utils.logging import get_logger

_logger = get_logger()

# Activity name parity (reference: horovod/common/common.h:31-55).
INIT_FUSION_BUFFER = "INIT_FUSION_BUFFER"
WAIT_FOR_DATA = "WAIT_FOR_DATA"
WAIT_FOR_OTHER_TENSOR_DATA = "WAIT_FOR_OTHER_TENSOR_DATA"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
XLA_ALLREDUCE = "XLA_ALLREDUCE"   # stands in for MPI_ALLREDUCE / NCCL_ALLREDUCE
XLA_ALLGATHER = "XLA_ALLGATHER"
XLA_BCAST = "XLA_BCAST"
NEGOTIATE_ALLREDUCE = "NEGOTIATE_ALLREDUCE"
NEGOTIATE_ALLGATHER = "NEGOTIATE_ALLGATHER"
NEGOTIATE_BROADCAST = "NEGOTIATE_BROADCAST"
ALLREDUCE = "ALLREDUCE"
ALLGATHER = "ALLGATHER"
BROADCAST = "BROADCAST"


def create_timeline(path, enabled=False, mark_cycles=False, collect=False,
                    multihost=False):
    """Native async writer (csrc/timeline.cc; a failed build raises), or
    the Python thread writer below for a job of several processes. Same
    event schema either way.

    Multi-host jobs always use the Python writer: ONE global trace is
    written by process 0 (reference: rank 0's writer consumes every rank's
    events, timeline.h:46-74), which requires non-zero processes to
    ``collect`` events in memory for shipping and process 0 to splice
    remote events into its file — in-memory manipulation the native
    streaming writer doesn't do."""
    if enabled and (collect or multihost):
        return Timeline(path, enabled=enabled, mark_cycles=mark_cycles,
                        collect=collect)
    if enabled and path:
        from . import native
        t = NativeTimeline(native.get_lib(), path, mark_cycles)
        if not t.enabled:
            raise OSError(f"cannot open the timeline file {path}")
        return t
    return Timeline(path, enabled=False, mark_cycles=mark_cycles)


class NativeTimeline:
    """ctypes facade over csrc/timeline.cc (same state machine as
    Timeline)."""

    def __init__(self, lib, path, mark_cycles):
        self._lib = lib
        self._start = time.perf_counter()
        self._h = lib.hvd_timeline_new(str(path).encode(),
                                       1 if mark_cycles else 0)
        self.enabled = bool(self._h)
        self._mark_cycles = mark_cycles

    def _ts(self):
        return int((time.perf_counter() - self._start) * 1e6)

    def _ev(self, tensor, name, phase, tid):
        if not self.enabled:
            return
        self._lib.hvd_timeline_event(self._h, tensor.encode(),
                                     name.encode() if name else None,
                                     phase, self._ts(), tid)

    def negotiate_start(self, tensor_name, op_name):
        self._ev(tensor_name, f"NEGOTIATE_{op_name}", b"B", 0)

    def negotiate_end(self, tensor_name):
        self._ev(tensor_name, None, b"E", 0)

    def start(self, tensor_name, op_name):
        self._ev(tensor_name, op_name, b"B", 0)

    def activity_start(self, tensor_name, activity):
        self._ev(tensor_name, activity, b"B", 1)

    def activity_end(self, tensor_name):
        self._ev(tensor_name, None, b"E", 1)

    def end(self, tensor_name):
        self._ev(tensor_name, None, b"E", 0)

    def mark_cycle_start(self):
        if self.enabled and self._mark_cycles:
            self._lib.hvd_timeline_cycle(self._h, self._ts())

    def counter(self, name, value):
        """Chrome "C" counter sample (metrics.py splices registry values in
        here so metrics and trace share one file)."""
        if not self.enabled:
            return
        self._lib.hvd_timeline_counter(self._h, name.encode(), self._ts(),
                                       float(value))

    def close(self):
        if self.enabled:
            self._lib.hvd_timeline_close(self._h)
            self.enabled = False


class Timeline:
    """Async Chrome-tracing writer keyed by tensor name.

    ``collect=True`` (multi-host, non-zero processes): events accumulate in
    ``self.collected`` instead of a file, for shipping to process 0 at
    shutdown (reference: every rank feeds rank 0's writer queue,
    timeline.h:46-74). ``epoch`` (wall-clock at construction) lets the
    merger align the per-process monotonic timestamps."""

    def __init__(self, path, enabled=False, mark_cycles=False,
                 collect=False):
        self._enabled = bool(enabled and (path or collect))
        self._collect = collect
        self._mark_cycles = mark_cycles
        self._start = time.perf_counter()
        self.epoch = time.time()
        self._pids = {}
        self._events = None
        self._thread = None
        self._file = None
        self.collected = [] if collect else None
        if self._enabled:
            if not collect:
                self._file = open(path, "w")
                self._file.write("[\n")
            self._events = queue.SimpleQueue()
            self._thread = threading.Thread(target=self._writer_loop,
                                            daemon=True)
            self._thread.start()

    @property
    def enabled(self):
        return self._enabled

    def _ts_us(self):
        return int((time.perf_counter() - self._start) * 1e6)

    def _emit(self, ev):
        self._events.put(ev)

    def _writer_loop(self):
        while True:
            ev = self._events.get()
            if ev is None:
                break
            if "_barrier" in ev:
                ev["_barrier"].set()
                continue
            if self._collect:
                self.collected.append(ev)
            else:
                self._file.write(json.dumps(ev) + ",\n")
        if self._file is not None:
            self._file.flush()

    def drain(self):
        """Flush queued events through the writer thread (collect mode:
        makes ``self.collected`` complete without closing)."""
        if not self._enabled:
            return
        barrier = threading.Event()
        self._events.put({"_barrier": barrier})
        if not barrier.wait(timeout=5):
            # writer thread dead or wedged: whatever was queued behind the
            # barrier never landed — say so instead of silently shipping a
            # truncated `collected` list to process 0
            _logger.warning(
                "timeline drain timed out; the shipped trace may be "
                "truncated (writer thread unresponsive)")

    def merge_remote(self, events, epoch, label):
        """Splice another process's collected events into this (still
        open) trace: tensor rows move to a disjoint pid space labeled
        ``label``, timestamps align via the wall-clock epochs (reference:
        rank 0 writes one file for every rank's tensors).

        A process that died before ``shutdown()`` ships no events (or a
        truncated/garbled list); its pid space still gets a labeled
        placeholder row so the merged trace stays a valid single file and
        the gap is visible in the viewer, and a malformed event is skipped
        individually instead of aborting the rest of the splice. Counter
        ("C") tracks ride the same pid remapping, so they survive a
        missing pid space unchanged."""
        if not self._enabled or self._collect:
            return
        offset_us = int((epoch - self.epoch) * 1e6)
        # Remote pid spaces start above every local pid (one local pid per
        # tensor name — a >10000-name trace must not collide with p1).
        default_base = max(10000,
                           max(self._pids.values(), default=0) + 10000)
        base = getattr(self, "_remote_pid_base", default_base)
        self._remote_pid_base = base + 10000
        merged = skipped = 0
        for ev in events or ():
            try:
                ev = dict(ev)
                if ev.get("ph") == "M":
                    args = ev.get("args") or {}
                    ev["args"] = {"name":
                                  f"{label}:{args.get('name', '?')}"}
                ev["pid"] = base + int(ev.get("pid", 0))
                if "ts" in ev:
                    ev["ts"] = int(ev["ts"]) + offset_us
            except (TypeError, ValueError, AttributeError):
                skipped += 1
                continue
            self._emit(ev)
            merged += 1
        if skipped:
            _logger.warning("timeline merge: skipped %d malformed events "
                            "from %s", skipped, label)
        if not merged:
            _logger.warning(
                "timeline merge: no events from %s (process died before "
                "shutdown?); emitting placeholder row", label)
            self._emit({"name": "process_name", "ph": "M", "pid": base,
                        "args": {"name": f"{label}: (no events — died "
                                         f"before shutdown?)"}})

    def _pid(self, tensor_name):
        pid = self._pids.get(tensor_name)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[tensor_name] = pid
            self._emit({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": tensor_name}})
        return pid

    # -- the reference state machine: NEGOTIATING -> TOP_LEVEL -> ACTIVITY --

    def negotiate_start(self, tensor_name, op_name):
        """Reference: Timeline::NegotiateStart (timeline.cc) emitting
        NEGOTIATE_<OP>."""
        if not self._enabled:
            return
        self._emit({"name": f"NEGOTIATE_{op_name}", "ph": "B",
                    "pid": self._pid(tensor_name), "tid": 0,
                    "ts": self._ts_us()})

    def negotiate_end(self, tensor_name):
        if not self._enabled:
            return
        self._emit({"ph": "E", "pid": self._pid(tensor_name), "tid": 0,
                    "ts": self._ts_us()})

    def start(self, tensor_name, op_name):
        """Top-level op state (ALLREDUCE / ALLGATHER / BROADCAST)."""
        if not self._enabled:
            return
        self._emit({"name": op_name, "ph": "B",
                    "pid": self._pid(tensor_name), "tid": 0,
                    "ts": self._ts_us()})

    def activity_start(self, tensor_name, activity):
        if not self._enabled:
            return
        self._emit({"name": activity, "ph": "B",
                    "pid": self._pid(tensor_name), "tid": 1,
                    "ts": self._ts_us()})

    def activity_end(self, tensor_name):
        if not self._enabled:
            return
        self._emit({"ph": "E", "pid": self._pid(tensor_name), "tid": 1,
                    "ts": self._ts_us()})

    def end(self, tensor_name):
        if not self._enabled:
            return
        self._emit({"ph": "E", "pid": self._pid(tensor_name), "tid": 0,
                    "ts": self._ts_us()})

    def mark_cycle_start(self):
        """Reference: Timeline::MarkCycleStart (timeline.h:97), gated on
        HOROVOD_TIMELINE_MARK_CYCLES."""
        if not (self._enabled and self._mark_cycles):
            return
        self._emit({"name": "CYCLE_START", "ph": "i", "pid": 0, "tid": 0,
                    "ts": self._ts_us(), "s": "g"})

    def counter(self, name, value):
        """Chrome "C" counter sample: one series per metric name, rendered
        by the trace viewer as a stacked counter track. metrics.py's
        exporter splices registry counters/gauges in here each tick so
        metrics and trace land in one file (no reference analog — the
        reference's timeline records only state transitions)."""
        if not self._enabled:
            return
        self._emit({"name": name, "ph": "C", "pid": 0, "tid": 0,
                    "ts": self._ts_us(), "args": {"value": float(value)}})

    def close(self):
        if not self._enabled:
            return
        self._events.put(None)
        self._thread.join(timeout=5)
        if self._file is not None:
            # Close the JSON array so Chrome accepts the file even though
            # the reference leaves it dangling; trailing comma is tolerated
            # with "]".
            self._file.write("{}]\n")
            self._file.close()
        self._enabled = False
