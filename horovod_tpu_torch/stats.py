"""Per-collective profiling statistics (fork parity).

Counterpart of the pure-Python ``CollectiveStats`` of horovod_tpu/stats.py:
call counters and per-message-size time histograms for every
collective, dumped to ``profiler.txt`` at shutdown in the fork's
CSV-ish layout (a ``Counter <op>,N`` line, a ``Time <op>,T,microseconds``
line, then a ``Message size,count,Time per call,Total time`` table per
collective).

In eager torch every collective is launched from the host, so each
execution is recorded once: its op, its wire bytes and its time from
launch to completion. On the CPU (gloo) the wait blocks, and the time is
the host's. On a card the wait only orders streams, so the time is
taken between two CUDA events on the caller's stream, one recorded just
before the launch and one just after the wait, and is read when the
second event has completed: :meth:`CollectiveStats.record_events` queues
it and folds what has completed without waiting (:meth:`poll`; the
flight recorder's ``wire_end`` is recorded then), and every read
resolves the queue first. The step never blocks on the clock. The
ctypes ``NativeCollectiveStats`` comes with the native
control plane (ROADMAP.md, Queue 1 item 10).

A collective captured into a CUDA graph (ops/step_program.py) has no
host time of its own: its events would become graph nodes. It is
recorded as ``<op>_jit`` once, when the program is captured
(:func:`record_jit_traced`), as the JAX package records a jitted
collective once per trace; the program records it again on every
replay only under ``HOROVOD_PROFILER_JIT_CALLBACKS=1``
(:func:`replay_jit`). A capture that only maps a program's phases for
a trace (diag/xla_trace.py) records nothing: it runs under
:func:`untraced`.
"""

import contextlib
import os
import threading
import time
from collections import defaultdict

_untraced = 0  # > 0 inside untraced(), on every thread


class _OpStats:
    __slots__ = ("counter", "total_time_us", "size_count", "size_time_us")

    def __init__(self):
        self.counter = 0
        self.total_time_us = 0
        self.size_count = defaultdict(int)
        self.size_time_us = defaultdict(int)


class CollectiveStats:
    """Registry of per-collective counters and message-size histograms."""

    # The JAX package's op set, so the dump lists the same rows.
    OPS = ("allreduce", "allreduce_cached", "allreduce_jit",
           "allgather", "allgather_jit", "broadcast", "broadcast_jit",
           "alltoall", "alltoall_jit", "reducescatter", "reducescatter_jit",
           "gather", "gatherv")

    def __init__(self):
        self._lock = threading.Lock()
        self._ops = {op: _OpStats() for op in self.OPS}
        # (op, nbytes, start event, end event, on_resolve)
        self._pending = []

    def record(self, op, nbytes, elapsed_s):
        with self._lock:
            self._record(op, nbytes, elapsed_s)

    def _record(self, op, nbytes, elapsed_s):
        s = self._ops.setdefault(op, _OpStats())
        us = int(elapsed_s * 1e6)
        s.counter += 1
        s.total_time_us += us
        s.size_count[int(nbytes)] += 1
        s.size_time_us[int(nbytes)] += us

    def record_events(self, op, nbytes, start, end, on_resolve=None):
        """Queue one execution timed by two CUDA events on one stream;
        it counts once ``end`` has completed (see the module note), and
        then ``on_resolve(seconds)`` runs (the flight recorder's
        ``wire_end``). Executions already completed are folded now,
        without waiting."""
        with self._lock:
            self._pending.append((op, nbytes, start, end, on_resolve))
        self.poll()

    def _fold(self, entry):
        op, nbytes, start, end, on_resolve = entry
        seconds = start.elapsed_time(end) / 1e3
        self._record(op, nbytes, seconds)
        return on_resolve, seconds

    def _callbacks(self, done):
        for on_resolve, seconds in done:
            if on_resolve is not None:
                on_resolve(seconds)

    def poll(self):
        """Fold the queued executions whose end event has completed;
        never waits."""
        with self._lock:
            ready, waiting = [], []
            for entry in self._pending:
                (ready if entry[3].query() else waiting).append(entry)
            if not ready:
                return
            self._pending = waiting
            done = [self._fold(e) for e in ready]
        self._callbacks(done)

    def resolve(self):
        """Fold every queued execution into the counters, waiting for
        events that have not completed yet."""
        with self._lock:
            pending, self._pending = self._pending, []
            for entry in pending:
                entry[3].synchronize()
            done = [self._fold(e) for e in pending]
        self._callbacks(done)

    class _Timer:
        def __init__(self, stats, op, nbytes):
            self._stats, self._op, self._nbytes = stats, op, nbytes

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._stats.record(self._op, self._nbytes,
                               time.perf_counter() - self._t0)
            return False

    def timer(self, op, nbytes):
        """Context manager timing one collective call of ``nbytes`` bytes
        on the host's clock."""
        return self._Timer(self, op, nbytes)

    def jit_records(self):
        """``{(op, nbytes): calls}`` of the ``*_jit`` rows: a program
        diffs it around its capture to learn what one replay records."""
        with self._lock:
            return {(op, sz): n for op, s in self._ops.items()
                    if op.endswith("_jit")
                    for sz, n in s.size_count.items()}

    def counter(self, op):
        self.resolve()
        return self._ops[op].counter

    def total_time_us(self, op):
        self.resolve()
        return self._ops[op].total_time_us

    def histogram(self, op):
        self.resolve()
        s = self._ops[op]
        with self._lock:
            return {sz: (s.size_count[sz], s.size_time_us[sz])
                    for sz in sorted(s.size_count)}

    def write_to_file(self, path):
        """Dump in the fork's profiler.txt CSV-ish layout."""
        self.resolve()
        lines = []
        for op in self.OPS:
            s = self._ops[op]
            pretty = op.replace("_", " ")
            lines.append(f"Counter {pretty},{s.counter}")
            lines.append(f"Time {pretty},{s.total_time_us},microseconds")
            lines.append("Message size,count,Time per call,Total time")
            with self._lock:
                for sz in sorted(s.size_count):
                    cnt = s.size_count[sz]
                    tot = s.size_time_us[sz]
                    lines.append(f"{sz},{cnt},{tot // max(cnt, 1)},{tot}")
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


def record_jit(op, nbytes):
    """Record one execution of a program's collective (no host time of
    its own) in the live session's stats; a no-op without a session."""
    from . import runtime
    if runtime.is_initialized():
        runtime._state.stats.record(op, int(nbytes), 0.0)


def record_jit_traced(op, nbytes):
    """Record a collective being captured into a program (``op`` is the
    ``*_jit`` row): once per capture. Its replays record through
    :func:`replay_jit`, and only under HOROVOD_PROFILER_JIT_CALLBACKS=1,
    which the program reads when it is captured."""
    if not _untraced:
        record_jit(op, nbytes)


def tracing():
    """False inside :func:`untraced`: a capture there is not a program
    of its own, and what it traces must not count."""
    return not _untraced


@contextlib.contextmanager
def untraced():
    """Run a capture whose collectives and wire bytes are not recorded
    (the phase map's re-capture of a program, ops/step_program.py):
    process-wide, since the gradient hooks run on autograd's thread."""
    global _untraced
    _untraced += 1
    try:
        yield
    finally:
        _untraced -= 1


def replay_jit(records):
    """Record one replay of a program whose capture recorded
    ``records`` (``[(op, nbytes)]``)."""
    for op, nbytes in records:
        record_jit(op, nbytes)


def register_metrics(stats):
    """Mirror the live session's per-collective registry into the
    process-wide metrics snapshot: a collect hook copies each op's call
    counter and cumulative time into the ``hvd_collective_calls`` and
    ``hvd_collective_time_us`` gauges, so a snapshot and the
    profiler.txt dump read the same numbers."""
    from . import metrics

    def _collect():
        for op in CollectiveStats.OPS:
            metrics.COLLECTIVE_CALLS.labels(op=op).set(stats.counter(op))
            metrics.COLLECTIVE_TIME_US.labels(op=op).set(
                stats.total_time_us(op))

    metrics.registry().set_collect_hook("collective_stats", _collect)
