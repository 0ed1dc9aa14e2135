"""Runtime lock-order witness: deadlock detection by acquisition graph.

Counterpart of horovod_tpu/analysis/lockwitness.py, scoped to the port.
The static HVD002 rule proves guarded fields stay under their lock; it
cannot prove the *order* locks are taken in is consistent across
threads. This witness does: it wraps every ``threading.Lock``/
``RLock``/``Condition`` created from horovod_tpu_torch code (engine
lock, coordinator lock + coordinate mutex, metrics registry,
completion/ticker/watchdog/prefetch threads), records the cross-thread
acquisition-order graph while a workload runs, and reports cycles —
for each potential deadlock, the two acquisition stacks that form it.

A cycle A→B / B→A is only a *potential deadlock* when the conflicting
orders are taken by different threads (one thread taking both orders at
different times can never contend with itself), so single-thread cycles
are filtered out of ``cycles`` but kept in ``edges`` for audit.

Cost model: bookkeeping happens only on *blocking* acquires and is a
few dict operations; full stacks are captured lazily — only the first
time a new graph edge appears (frame objects are held while the lock is
held, formatted on demand). Non-blocking ``acquire(False)`` succeeds
without waiting, so it cannot deadlock and records nothing (the
engine's poll() trylock idiom stays invisible, by design).

Activation is programmatic (tests/test_torch_analysis.py installs it
around the port's threaded paths)::

    w = LockOrderWitness()
    w.install()            # patches threading.Lock/RLock/Condition
    ...                    # run workload
    report = w.report()
    w.uninstall()
    assert not report["cycles"]

Findings are also surfaced through the flight-recorder event vocabulary
(``lock_cycle`` events, docs/diagnostics.md) when a recorder is
installed (the port's, horovod_tpu_torch/diag/recorder.py), so a
deadlock found in CI reads like any other post-mortem.
"""

import json
import os
import sys
import threading
import traceback

#: Only locks created from files whose path contains one of these
#: substrings are witnessed; everything else (stdlib, torch internals,
#: the JAX package) passes through untouched.
DEFAULT_SCOPE = ("horovod_tpu_torch",)

_STACK_LIMIT = 16

#: Raw factories captured at import, before any witness installs. Used
#: for the witness's own bookkeeping and for ``make_lock``/``make_rlock``
#: so a second witness (a unit test) never hands its locks to an
#: installed session witness — its deliberate inversions would poison
#: the session graph.
_RAW_LOCK = threading.Lock
_RAW_RLOCK = threading.RLock


class _WitnessedLock:
    """Proxy over a real Lock/RLock implementing enough of the RLock
    protocol (``_release_save``/``_acquire_restore``/``_is_owned``) that
    ``threading.Condition`` built on it behaves identically."""

    __slots__ = ("_inner", "_witness", "key", "label", "reentrant")

    def __init__(self, inner, witness, key, label, reentrant):
        self._inner = inner
        self._witness = witness
        self.key = key
        self.label = label
        self.reentrant = reentrant

    # -- core lock protocol

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok and blocking:
            self._witness._note_acquire(self)
        elif ok:
            self._witness._note_acquire(self, trylock=True)
        return ok

    def release(self):
        self._witness._note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # -- RLock protocol used by threading.Condition

    def _release_save(self):
        self._witness._note_release_all(self)
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._witness._note_acquire(self)

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<WitnessedLock {self.label} wrapping {self._inner!r}>"


class LockOrderWitness:
    """Acquisition-order graph over witnessed locks, with cycle report."""

    def __init__(self, scope=DEFAULT_SCOPE):
        self.scope = tuple(scope)
        self._tls = threading.local()
        self._mtx = _RAW_LOCK()  # raw: guards the graph, never held
        #                               while acquiring a witnessed lock
        self._edges = {}   # (key_a, key_b) -> edge record
        self._labels = {}  # key -> label
        self._nlocks = 0
        self._installed = False
        self._orig = None

    # ------------------------------------------------------------- patching

    def install(self):
        """Patch threading lock factories. Locks created before install
        (module-import-time singletons) are not witnessed; everything the
        engine/coordinator builds per-init afterwards is."""
        if self._installed:
            return self
        self._orig = (threading.Lock, threading.RLock, threading.Condition)
        orig_lock, orig_rlock, orig_condition = self._orig
        witness = self

        def make_lock():
            inner = orig_lock()
            return witness._maybe_wrap(inner, reentrant=False, depth=2)

        def make_rlock():
            inner = orig_rlock()
            return witness._maybe_wrap(inner, reentrant=True, depth=2)

        class WitnessCondition(orig_condition):
            def __init__(self, lock=None):
                if lock is None:
                    inner = orig_rlock()
                    lock = witness._maybe_wrap(inner, reentrant=True,
                                               depth=2)
                super().__init__(lock)

        threading.Lock = make_lock
        threading.RLock = make_rlock
        threading.Condition = WitnessCondition
        self._installed = True
        return self

    def uninstall(self):
        if self._installed:
            (threading.Lock, threading.RLock,
             threading.Condition) = self._orig
            self._installed = False

    def _maybe_wrap(self, inner, reentrant, depth):
        """Wrap only when the creating frame is in scope. Walks one
        frame past our factory to the caller."""
        try:
            frame = sys._getframe(depth)
            filename = frame.f_code.co_filename
            site = f"{os.path.basename(filename)}:{frame.f_lineno}"
        except ValueError:  # pragma: no cover - no caller frame
            return inner
        norm = filename.replace(os.sep, "/")
        if not any(s in norm for s in self.scope):
            return inner
        return self._wrap(inner, reentrant, site)

    def _wrap(self, inner, reentrant, label):
        with self._mtx:
            self._nlocks += 1
            key = f"{label}#{self._nlocks}"
            self._labels[key] = label
        return _WitnessedLock(inner, self, key, label, reentrant)

    def make_lock(self, label="test"):
        """Explicitly-scoped lock for unit tests."""
        return self._wrap(_RAW_LOCK(), False, label)

    def make_rlock(self, label="test"):
        return self._wrap(_RAW_RLOCK(), True, label)

    # ----------------------------------------------------------- accounting

    def _held(self):
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, lock, trylock=False):
        held = self._held()
        for entry in held:
            if entry[0] is lock:
                entry[2] += 1  # RLock re-entry: no new edge
                return
        frame = sys._getframe(2)
        if not trylock:
            self._record_edges(held, lock, frame)
        held.append([lock, frame, 1])

    def _note_release(self, lock):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                held[i][2] -= 1
                if held[i][2] <= 0:
                    del held[i]
                return

    def _note_release_all(self, lock):
        """Condition.wait's _release_save drops the lock entirely."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    def _record_edges(self, held, lock, frame):
        if not held:
            return
        tid = threading.get_ident()
        tname = threading.current_thread().name
        for prev_lock, prev_frame, _ in held:
            if prev_lock.key == lock.key:
                continue
            edge_key = (prev_lock.key, lock.key)
            with self._mtx:
                edge = self._edges.get(edge_key)
                if edge is None:
                    self._edges[edge_key] = {
                        "from": prev_lock.key, "to": lock.key,
                        "threads": {f"{tname}-{tid}"},
                        "count": 1,
                        "stack_from": traceback.format_stack(
                            prev_frame, limit=_STACK_LIMIT),
                        "stack_to": traceback.format_stack(
                            frame, limit=_STACK_LIMIT),
                    }
                else:
                    edge["threads"].add(f"{tname}-{tid}")
                    edge["count"] += 1

    # -------------------------------------------------------------- report

    def _find_cycles(self):
        """Elementary cycles in the edge graph via DFS, deduplicated by
        node set (the graphs here are tiny — a handful of locks)."""
        graph = {}
        for a, b in self._edges:
            graph.setdefault(a, set()).add(b)
        cycles, seen = [], set()

        def dfs(start, node, path):
            for nxt in graph.get(node, ()):
                if nxt == start:
                    sig = frozenset(path)
                    if sig not in seen:
                        seen.add(sig)
                        cycles.append(list(path))
                elif nxt not in path and nxt > start:
                    # Only explore nodes ordered after start: each cycle
                    # is found exactly once, rooted at its min node.
                    dfs(start, nxt, path + [nxt])

        for start in sorted(graph):
            dfs(start, start, [start])
        return cycles

    @staticmethod
    def _deadlockable(cycle_edges):
        """A cycle is a potential deadlock unless one single thread is
        the only observer of every edge in it."""
        thread_sets = [e["threads"] for e in cycle_edges]
        common = set.intersection(*thread_sets) if thread_sets else set()
        return not (len(common) == 1
                    and all(ts == common for ts in thread_sets))

    def report(self):
        """{"locks", "edges", "cycles"} — ``cycles`` entries carry the
        edge list with both acquisition stacks (the two stacks forming
        each potential deadlock)."""
        with self._mtx:
            edges = {k: dict(v, threads=sorted(v["threads"]))
                     for k, v in self._edges.items()}
        cycles = []
        for nodes in self._find_cycles():
            ring = nodes + [nodes[0]]
            cycle_edges = []
            for a, b in zip(ring, ring[1:]):
                e = edges.get((a, b))
                if e is not None:
                    cycle_edges.append(e)
            if len(cycle_edges) == len(nodes) and self._deadlockable(
                    [self._edges[(e["from"], e["to"])]
                     for e in cycle_edges]):
                cycles.append({
                    "locks": [f"{n} ({self._labels.get(n, '?')})"
                              for n in nodes],
                    "edges": cycle_edges,
                })
        self._emit_flight_events(cycles)
        return {
            "locks": self._nlocks,
            "edges": sorted(edges.values(),
                            key=lambda e: (e["from"], e["to"])),
            "cycles": cycles,
        }

    @staticmethod
    def _emit_flight_events(cycles):
        """Speak the flight-recorder event vocabulary so a CI deadlock
        reads like any other diagnosed incident (docs/diagnostics.md)."""
        if not cycles:
            return
        try:
            from ..diag import recorder as _rec
        except Exception:  # pragma: no cover - analysis used standalone
            return
        rec = _rec.get()
        if rec is None:
            return
        for c in cycles:
            rec.record("lock_cycle", name="->".join(c["locks"]),
                       op="LOCK_WITNESS",
                       extra={"n_edges": len(c["edges"])})

    def write_report(self, path="lock-witness-report.json"):
        rep = self.report()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rep, f, indent=1, default=str)
        os.replace(tmp, path)
        return rep


def format_cycles(report):
    """Human-readable deadlock summary: the lock ring plus the two
    stacks forming each conflicting edge."""
    lines = []
    for i, c in enumerate(report.get("cycles", ()), start=1):
        lines.append(f"potential deadlock #{i}: "
                     + " -> ".join(c["locks"]) + " -> (cycle)")
        for e in c["edges"]:
            lines.append(f"  edge {e['from']} -> {e['to']} "
                         f"(seen {e['count']}x on threads "
                         f"{', '.join(sorted(e['threads']))})")
            lines.append("    held-lock acquisition stack:")
            lines.extend("      " + ln.rstrip()
                         for ln in e["stack_from"][-4:])
            lines.append("    second acquisition stack:")
            lines.extend("      " + ln.rstrip()
                         for ln in e["stack_to"][-4:])
    return "\n".join(lines)
