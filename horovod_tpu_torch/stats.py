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
it, and every read resolves the queue first. The step never blocks on
the clock. The ctypes ``NativeCollectiveStats`` comes with the native
control plane (ROADMAP.md, Queue 1 item 10).
"""

import os
import threading
import time
from collections import defaultdict


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
        self._pending = []  # (op, nbytes, start event, end event)

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

    def record_events(self, op, nbytes, start, end):
        """Queue one execution timed by two CUDA events on one stream;
        it counts once ``end`` has completed (see the module note)."""
        with self._lock:
            self._pending.append((op, nbytes, start, end))

    def resolve(self):
        """Fold every queued execution into the counters, waiting for
        events that have not completed yet."""
        with self._lock:
            pending, self._pending = self._pending, []
            for op, nbytes, start, end in pending:
                end.synchronize()
                self._record(op, nbytes, start.elapsed_time(end) / 1e3)

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
