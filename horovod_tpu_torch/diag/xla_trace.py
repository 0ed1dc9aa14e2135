"""On-demand device tracing with per-phase attribution.

Counterpart of horovod_tpu/diag/xla_trace.py, under its module name,
knob (``HOROVOD_XPROF_STEPS``), metric families (``hvd_xla_*``), phase
names, capture directories (``xla-trace-<seq>/``) and sidecar
(``xla-trace-meta.json``), so a reader and a dashboard find the same
things. In the port the capture is ``torch.profiler``'s (kineto's Chrome
trace), not XLA's:

- The step's regions run under ``torch.profiler.record_function``
  ranges named as the JAX package's named scopes: ``hvd_forward`` /
  ``hvd_backward`` / ``hvd_exchange`` / ``hvd_optimizer``
  (ops/step_program.py, the gradient hooks of optimizers.py),
  ``hvd_ici`` / ``hvd_dcn`` inside the staged exchange
  (ops/collectives.py), ``hvd_dispatch`` / ``hvd_expert`` /
  ``hvd_combine`` in the MoE layer (models/moe.py) and ``hvd_prefill``
  / ``hvd_decode`` in the serve programs (serve/engine.py).
- ``hvd.trace_steps(n)`` (or ``HOROVOD_XPROF_STEPS=n``) arms a one-shot
  :class:`StepTracer`. The next ``n`` steps are captured with
  ``torch.profiler`` into ``xla-trace-<seq>/`` under
  ``HOROVOD_DIAG_DIR``.
- :func:`parse_trace_dir` gives each device event (kernel, memcpy,
  memset) the phase of the innermost ``hvd_`` range that encloses its
  launch: the CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernel``,
  ...) carrying the event's correlation id. The join is by time across
  every thread of the process, since a CUDA backward and its gradient
  hooks run on autograd's device thread, not on the thread that opened
  ``hvd_backward``. The scope path of the
  enclosing ranges is resolved as the JAX package resolves an
  ``op_name``: the LAST ``hvd_`` label wins. A trace without device
  events (the CPU) attributes its top-level host ops instead.
- A replayed CUDA graph runs no host code: every kernel of a replay
  correlates to its one ``cudaGraphLaunch``. The counterpart of the JAX
  package's HLO map is a per-program phase map: the first time a
  traced window replays a program (ops/step_program.py ``StepProgram``)
  that has none, the program captures its function once more under the
  profiler (``hvd_recapture:<key>``; nothing executes, and the graph is
  dropped), which records each node's launch inside its ``hvd_``
  ranges. Each replay (``hvd_graph:<key>``) then takes its events in
  start order against that launch sequence. CUPTI can drop device
  records under load: a replay short of k events places each event on
  the nodes it may be (i..i+k), where they share one phase; an event
  that cannot be placed falls into ``other`` and is counted
  (``unmatched``), and the dropped ones are counted (``lost``).

The parsed summary plus the wall-clock window is written next to the
capture as ``xla-trace-meta.json``, with the phase maps, so the
``python -m horovod_tpu_torch.diag --xla-trace`` merger can
clock-align and phase-label the device view offline.

Inert by default: no tracer object exists until armed, and the per-step
cost with a tracer installed but idle is one attribute check.
"""

import gzip
import heapq
import json
import os
import re
import time

from .. import metrics
from ..utils.logging import get_logger
from . import recorder

_logger = get_logger()

#: Step-program regions, the MoE sub-phases (``hvd_dispatch`` /
#: ``hvd_expert`` / ``hvd_combine`` — dispatch/combine wrap ONLY the
#: all-to-alls, expert wraps the expert FFN, so their buckets are pure
#: wire vs pure compute) and the serve programs' scopes (``hvd_prefill``
#: / ``hvd_decode``); the parse buckets. ``other`` collects device time
#: outside any hvd_ range.
PHASES = ("forward", "backward", "exchange", "optimizer", "guard",
          "dispatch", "expert", "combine", "prefill", "decode")
#: Staged-exchange tiers annotated by ops/collectives.py.
STAGES = ("ici", "dcn")

META_FILENAME = "xla-trace-meta.json"
#: Seconds the profiler warms up (CUPTI on, nothing kept) before a
#: window records.
WARMUP_S = 0.05

_PHASE_RE = re.compile(r"hvd_(forward|backward|exchange|optimizer|guard"
                       r"|dispatch|expert|combine|prefill|decode)")
_STAGE_RE = re.compile(r"hvd_(ici|dcn)")

#: Range names a program's replay and re-capture run under; the key
#: names its phase map.
GRAPH_PREFIX = "hvd_graph:"
RECAPTURE_PREFIX = "hvd_recapture:"

# kineto categories: what the device ran, and the host calls that
# launched it (a cuda* call and the cu* call it makes share one
# correlation id).
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
# Host calls that add a node to a graph under capture: kernel launches,
# copies and sets (not event records or waits).
_NODE_RE = re.compile(r"Launch(?!HostFunc)|Memcpy|Memset")
# The calls that open and close a stream capture.
_CAPTURE_MARKS = ("cudaStreamBeginCapture", "cudaStreamEndCapture",
                  "cuStreamBeginCapture", "cuStreamEndCapture",
                  "cuStreamBeginCapture_v2")


def phase_of_op_name(op_name):
    """Phase bucket for a scope path (``/``-joined ``hvd_`` range names,
    outermost first), or None when the event sits outside every hvd_
    range. The LAST hvd_ label wins so collectives nested inside
    ``hvd_optimizer`` (ZeRO modes exchange inside the update) attribute
    to ``exchange``."""
    hits = _PHASE_RE.findall(op_name or "")
    return hits[-1] if hits else None


def stage_of_op_name(op_name):
    """``ici`` / ``dcn`` tier for a scope path, or None."""
    hits = _STAGE_RE.findall(op_name or "")
    return hits[-1] if hits else None


def _iter_trace_files(trace_dir):
    for dirpath, _, filenames in os.walk(trace_dir):
        for fn in sorted(filenames):
            if fn.endswith(".trace.json.gz") or fn.endswith(".trace.json"):
                yield os.path.join(dirpath, fn)


def _load_trace_events(path):
    """The ``traceEvents`` list from one capture file, or None when the
    file is unreadable/malformed — the caller skips it (bad trace files
    degrade to "no data", never a crash)."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
                doc = json.load(f)
        else:
            with open(path, encoding="utf-8", errors="replace") as f:
                doc = json.load(f)
    except Exception:  # noqa: BLE001 - malformed capture, skip
        _logger.warning("xla_trace: skipping unreadable trace file %s", path)
        return None
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    return events if isinstance(events, list) else None


def _merge_intervals(ivs):
    """Union of (start, end) intervals as a sorted disjoint list."""
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _overlap_us(iv, merged):
    """Length of ``iv``'s intersection with a merged interval union."""
    s, e = iv
    total = 0.0
    for ms, me in merged:
        if me <= s:
            continue
        if ms >= e:
            break
        total += min(e, me) - max(s, ms)
    return total


def _num(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _complete(events, cats):
    """``"X"`` events of the categories ``cats`` with numeric times."""
    return [ev for ev in events
            if isinstance(ev, dict) and ev.get("ph") == "X"
            and ev.get("cat") in cats and _num(ev.get("ts"))]


def _corr(ev):
    args = ev.get("args")
    return args.get("correlation") if isinstance(args, dict) else None


def _scope_paths(points, ranges):
    """For host times ``points`` ([(t, i)]), the ``/``-joined names of
    the ranges ([(start, end, name)]) enclosing each, outermost first:
    {i: path}. A sweep over both in time order, across threads."""
    out = {}
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    active = []  # heap of (end, start, name)
    j = 0
    for t, i in sorted(points):
        while j < len(ranges) and ranges[j][0] <= t:
            heapq.heappush(active, (ranges[j][1], ranges[j][0],
                                    ranges[j][2]))
            j += 1
        while active and active[0][0] < t:
            heapq.heappop(active)
        if active:
            out[i] = "/".join(n for _, _, n in
                              sorted(active, key=lambda a: (a[1], -a[0])))
    return out


def _top_level_host_ops(events):
    """Host ops of a trace without device events (the CPU): each
    ``cpu_op`` not nested in another on its thread."""
    out = []
    by_tid = {}
    for ev in _complete(events, ("cpu_op",)):
        by_tid.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    for evs in by_tid.values():
        end = None
        for ev in sorted(evs, key=lambda e: (e["ts"],
                                             -float(e.get("dur") or 0.0))):
            if end is not None and ev["ts"] < end:
                continue
            out.append(ev)
            end = ev["ts"] + float(ev.get("dur") or 0.0)
    return out


def _phase_ranges(events):
    """``[(start, end, name)]`` of the ``hvd_`` ranges that name phases
    and tiers (not a program's replay or re-capture)."""
    return [(ev["ts"], ev["ts"] + float(ev.get("dur") or 0.0), ev["name"])
            for ev in _complete(events, ("user_annotation",))
            if str(ev.get("name", "")).startswith("hvd_")
            and not str(ev["name"]).startswith((GRAPH_PREFIX,
                                                RECAPTURE_PREFIX))]


def build_op_phase_map(events):
    """``{key: [scope path, ...]}`` from one trace's events: for each
    program re-captured under the profiler (``hvd_recapture:<key>``), the
    scope path of every graph node it captured, in capture order (the
    port's counterpart of the JAX package's HLO ``op_name`` map): the
    node-making calls between the capture's begin and end that ran
    nothing."""
    recaps = [(ev["ts"], ev["ts"] + float(ev.get("dur") or 0.0),
               ev["name"][len(RECAPTURE_PREFIX):])
              for ev in _complete(events, ("user_annotation",))
              if str(ev.get("name", "")).startswith(RECAPTURE_PREFIX)]
    if not recaps:
        return {}
    ranges = _phase_ranges(events)
    executed = {_corr(ev) for ev in _complete(events, _DEVICE_CATS)}
    seen, launches = set(), []
    for ev in sorted(_complete(events, _LAUNCH_CATS), key=lambda e: e["ts"]):
        c = _corr(ev)
        if (c is None or c in seen or c in executed
                or not _NODE_RE.search(str(ev.get("name", "")))
                or ev.get("name") in _GRAPH_LAUNCHES):
            continue
        seen.add(c)
        launches.append(ev)
    paths = _scope_paths([(ev["ts"], i) for i, ev in enumerate(launches)],
                         ranges)
    marks = sorted((ev["ts"], ev["name"]) for ev in _complete(
        events, _LAUNCH_CATS) if ev.get("name") in _CAPTURE_MARKS)
    out = {}
    for start, end, key in recaps:
        # the capture proper: graph.capture_begin() launches its RNG
        # state's fills before cudaStreamBeginCapture, and they run
        begin = next((t for t, n in marks if start <= t <= end
                      and n.endswith("BeginCapture")), start)
        stop = next((t for t, n in reversed(marks) if start <= t <= end
                     and n.endswith("EndCapture")), end)
        out[key] = [paths.get(i, "") for i, ev in enumerate(launches)
                    if begin <= ev["ts"] <= stop]
    return out


def parse_trace_dir(trace_dir, op_map=None):
    """Parse a ``torch.profiler`` capture directory into per-phase device
    time. ``op_map`` holds the phase maps of programs re-captured in
    earlier windows (:func:`build_op_phase_map`); a map found in this
    capture is added to it. Returns None when the directory holds no
    parseable device events; otherwise a dict::

        {"phases": {phase: seconds, ..., "other": s},
         "stages": {"ici": s, "dcn": s},
         "moe": {...} or None,
         "exchange": {...} or None,
         "total_s": s, "events": n, "lanes": n_device_streams,
         "ts_min_us": t, "ts_max_us": t, "files": [paths],
         "graph_events": n, "unmatched": n, "op_map": {...},
         "graphs": {key: {"nodes", "events", "unmatched", "lost"}},
         "kernels": {name: {phase: seconds}}}

    ``lanes`` is the number of distinct device timelines (streams) that
    contributed. ``graph_events`` counts the events of replayed graphs,
    ``unmatched`` those of them no phase map could place (in
    ``other``), and ``graphs`` each program's: its map's length (None
    without one), its replays' events, the unmatched among them and the
    events its replays lost (their device time is in no phase).
    ``kernels`` is each event name's time by phase.

    ``moe`` appears when the capture contains MoE sub-phases
    (``hvd_dispatch``/``hvd_combine`` wrap only the dispatch/combine
    all-to-alls, ``hvd_expert`` only the expert FFN): ``hidden_s`` is
    the device time the all-to-all intervals spend overlapped with the
    union of expert-compute intervals across ALL lanes, and
    ``hidden_frac = hidden_s / alltoall_s``.

    ``exchange`` appears when the capture contains gradient-exchange
    device time (``hvd_exchange`` ranges): the same interval fold as
    ``moe``, with the compute union taken over the
    forward/backward/optimizer/expert phases across ALL lanes.
    ``hidden_frac = hidden_s / exchange_s`` feeds
    ``hvd_exchange_hidden_frac``."""
    if not trace_dir or not os.path.isdir(trace_dir):
        return None
    op_map = dict(op_map or {})
    phases = {p: 0.0 for p in PHASES}
    phases["other"] = 0.0
    stages = {s: 0.0 for s in STAGES}
    lanes = set()
    files, n_events, graph_events, unmatched = [], 0, 0, 0
    ts_min, ts_max = None, None
    expert_iv, a2a_iv = [], []
    exch_iv, compute_iv = [], []
    kernels, graphs = {}, {}
    for path in _iter_trace_files(trace_dir):
        events = _load_trace_events(path)
        if not events:
            continue
        files.append(path)
        op_map.update(build_op_phase_map(events))
        pairs, lost = _attributed(events, op_map)
        for key, n in lost.items():
            _graph_entry(graphs, key, op_map)["lost"] += n
        for ev, path_name in pairs:
            unmatched_now = path_name is _UNMATCHED
            if unmatched_now:
                unmatched += 1
                path_name = None
            key = ev.get("_graph")
            if key is not None:
                graph_events += 1
                g = _graph_entry(graphs, key, op_map)
                g["events"] += 1
                g["unmatched"] += path_name is None and unmatched_now
            dur = float(ev.get("dur") or 0.0)
            ts = ev["ts"]
            ts_min = ts if ts_min is None else min(ts_min, ts)
            end = ts + dur
            ts_max = end if ts_max is None else max(ts_max, end)
            n_events += 1
            lanes.add((ev.get("pid"), ev.get("tid")))
            phase = phase_of_op_name(path_name)
            stage = stage_of_op_name(path_name)
            bucket = phase if phase in phases else "other"
            phases[bucket] += dur
            by_phase = kernels.setdefault(str(ev.get("name", "")), {})
            by_phase[bucket] = by_phase.get(bucket, 0.0) + dur * 1e-6
            if stage in stages:
                stages[stage] += dur
            if phase == "expert":
                expert_iv.append((ts, ts + dur))
            elif phase in ("dispatch", "combine"):
                a2a_iv.append((ts, ts + dur))
            if phase == "exchange":
                exch_iv.append((ts, ts + dur))
            elif phase in ("forward", "backward", "optimizer", "expert"):
                compute_iv.append((ts, ts + dur))
    if n_events == 0:
        return None
    moe = None
    a2a_us = phases["dispatch"] + phases["combine"]
    if a2a_us > 0.0:
        merged = _merge_intervals(expert_iv)
        hidden_us = sum(_overlap_us(iv, merged) for iv in a2a_iv)
        moe = {
            "dispatch_s": phases["dispatch"] * 1e-6,
            "combine_s": phases["combine"] * 1e-6,
            "expert_s": phases["expert"] * 1e-6,
            "alltoall_s": a2a_us * 1e-6,
            "hidden_s": hidden_us * 1e-6,
            "hidden_frac": hidden_us / a2a_us,
        }
    exchange = None
    exch_us = phases["exchange"]
    if exch_us > 0.0:
        merged = _merge_intervals(compute_iv)
        hidden_us = sum(_overlap_us(iv, merged) for iv in exch_iv)
        exchange = {
            "exchange_s": exch_us * 1e-6,
            "hidden_s": hidden_us * 1e-6,
            "hidden_frac": hidden_us / exch_us,
        }
    to_s = 1e-6  # trace durations are microseconds
    return {
        "phases": {k: v * to_s for k, v in phases.items()},
        "stages": {k: v * to_s for k, v in stages.items()},
        "moe": moe,
        "exchange": exchange,
        "total_s": sum(phases.values()) * to_s,
        "events": n_events,
        "lanes": max(len(lanes), 1),
        "ts_min_us": ts_min,
        "ts_max_us": ts_max,
        "files": files,
        "graph_events": graph_events,
        "unmatched": unmatched,
        "op_map": op_map,
        "graphs": graphs,
        "kernels": kernels,
    }


_UNMATCHED = object()


def _graph_entry(graphs, key, op_map):
    return graphs.setdefault(key, {
        "nodes": len(op_map[key]) if key in op_map else None,
        "events": 0, "unmatched": 0, "lost": 0})


def _attributed(events, op_map):
    """``([(device event, scope path or None or _UNMATCHED)], {program
    key: events its replays lost})`` for one trace's events (the module
    docstring's join). Events of a replayed graph carry ``_graph``."""
    devices = _complete(events, _DEVICE_CATS)
    phase_ranges = _phase_ranges(events)
    if not devices:
        host = _top_level_host_ops(events)
        paths = _scope_paths([(ev["ts"], i) for i, ev in enumerate(host)],
                             phase_ranges)
        return [(ev, paths.get(i)) for i, ev in enumerate(host)], {}
    launches = {}
    for ev in _complete(events, _LAUNCH_CATS):
        c = _corr(ev)
        if c is not None and c not in launches:
            launches[c] = ev
    graph_ranges = [(ev["ts"], ev["ts"] + float(ev.get("dur") or 0.0),
                     ev["name"])
                    for ev in _complete(events, ("user_annotation",))
                    if str(ev.get("name", "")).startswith(GRAPH_PREFIX)]
    eager, graphs = [], {}
    for ev in devices:
        launch = launches.get(_corr(ev))
        if launch is not None and launch.get("name") in _GRAPH_LAUNCHES:
            graphs.setdefault(_corr(ev), (launch, []))[1].append(ev)
        else:
            eager.append((ev, launch))
    points = [(launch["ts"], i) for i, (ev, launch) in enumerate(eager)
              if launch is not None]
    paths = _scope_paths(points, phase_ranges)
    out = [(ev, paths.get(i)) for i, (ev, _) in enumerate(eager)]
    keys = _scope_paths([(launch["ts"], c) for c, (launch, _) in
                         graphs.items()], graph_ranges)
    lost = {}
    for c, (launch, evs) in graphs.items():
        key = keys.get(c, "").rsplit("/", 1)[-1][len(GRAPH_PREFIX):]
        seq = op_map.get(key)
        evs.sort(key=lambda e: (e["ts"], e.get("tid")))
        if seq is not None and len(evs) < len(seq):
            lost[key] = lost.get(key, 0) + len(seq) - len(evs)
        for ev, path in zip(evs, _place(evs, seq)):
            ev["_graph"] = key
            out.append((ev, path))
    return out, lost


def _place(evs, seq):
    """The scope path of each of a replay's events (start order) from
    its program's map ``seq``, or _UNMATCHED. A replay can lose events
    (CUPTI drops device records under load: seen on the card, a window's
    first kernels and whole decode replays), never gain or reorder them
    on one stream: with k lost, event i is node i..i+k, and it takes the
    path those nodes share, or stays unmatched where a phase boundary
    falls among them. With nothing lost that is node i."""
    if seq is None or len(evs) > len(seq):
        return [_UNMATCHED] * len(evs)
    k = len(seq) - len(evs)
    # run_end[j]: the last index of the run of equal paths holding j
    run_end = [0] * len(seq)
    for j in range(len(seq) - 1, -1, -1):
        run_end[j] = (run_end[j + 1] if j + 1 < len(seq)
                      and seq[j + 1] == seq[j] else j)
    return [(seq[i] or None) if run_end[i] >= i + k else _UNMATCHED
            for i in range(len(evs))]


def load_meta(trace_dir):
    """The capture's ``xla-trace-meta.json`` sidecar, or None."""
    path = os.path.join(trace_dir, META_FILENAME)
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except Exception:  # noqa: BLE001 - absent/corrupt sidecar
        return None


# ------------------------------------------------------------- the tracer

class StepTracer:
    """One-shot, step-aligned ``torch.profiler`` capture.

    ``arm(n)`` requests a window; the training loop calls :meth:`tick`
    once per step (``CompiledTrainStep.__call__`` does it on the hot
    path, ``TelemetryCallback`` covers eager loops, a serve loop ticks
    it itself). The first tick after arming starts the trace; after
    ``n`` further ticks the trace stops, parses, writes the sidecar meta
    and exports ``hvd_xla_phase_seconds`` / ``hvd_wire_stage_seconds``.
    Single training-thread discipline: tick/arm race at worst delays a
    capture by a step, never corrupts state."""

    def __init__(self, diag_dir="", rank=0, size=1):
        self.diag_dir = diag_dir or "."
        self.rank = rank
        self.size = size
        self.captures = 0
        self.last_summary = None
        self.last_dir = None
        self._want = 0
        self._n = 0
        self._seen = 0
        self._active = False
        self._owner = None
        self._seq = 0
        self._op_map = {}
        self._recaptured = set()
        self._prof = None
        self._wall_start = 0.0
        self._mono_start = 0.0

    @property
    def active(self):
        return self._active

    @property
    def armed(self):
        return self._want > 0

    def wants_phase_map(self, key):
        """Whether the program ``key`` should re-capture under this
        capture: a capture is running, no earlier window mapped it and
        it has not re-captured in this one (the counterpart of the JAX
        package's ``wants_hlo``: the cost stays strictly on demand)."""
        return (self._active and key not in self._op_map
                and key not in self._recaptured)

    def register_phase_map(self, key):
        """Note that ``key`` re-captured in this window; its map is read
        from the capture at :meth:`stop`."""
        self._recaptured.add(key)

    def arm(self, n, out_dir=None):
        """Request a capture of the next ``n`` full steps (n >= 1)."""
        n = int(n)
        if n <= 0:
            return
        if out_dir:
            self.diag_dir = out_dir
        # A new window re-locks to whoever ticks first: without this a
        # tracer reused across program objects (bench A/B, successive
        # profiles) would silently ignore the new step's cadence.
        self._owner = None
        self._want = n

    def tick(self, owner=None):
        """Step-boundary hook. ``owner`` locks the step cadence to the
        first caller that ticks (a compiled step and a telemetry
        callback in the same loop would otherwise double-count)."""
        if not self._want and not self._active:
            return
        if owner is not None:
            if self._owner is None:
                self._owner = owner
            elif self._owner is not owner:
                return
        if not self._active:
            self._start()
            return
        self._seen += 1
        if self._seen >= self._n:
            self.stop()

    def _start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule
        # Claim the first unused sequence dir: a tracer recreated after a
        # re-init restarts _seq at 0, and blindly reusing xla-trace-001
        # would mix two captures' event files and overwrite the earlier
        # sidecar meta with a join over both.
        # Ranks sharing a diag dir each claim under rank<r>/: a capture
        # directory holds one process's trace.
        root = (self.diag_dir if self.size <= 1
                else os.path.join(self.diag_dir, f"rank{self.rank}"))
        for _ in range(1000):
            self._seq += 1
            out = os.path.join(root, f"xla-trace-{self._seq:03d}")
            if not (os.path.isdir(out) and os.listdir(out)):
                break
        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(out, exist_ok=True)
            # A warm-up before the recording: on the card, a window that
            # started recording at once lost every device event of its
            # first 28 ms (a replay's first 8 kernels among them); warmed
            # up, a window loses a few at most, which the graph join
            # tolerates (_place).
            prof = profile(activities=activities,
                           schedule=schedule(wait=0, warmup=1, active=1))
            prof.start()
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            time.sleep(WARMUP_S)
            prof.step()
        except Exception:  # noqa: BLE001 - e.g. a foreign trace is active
            _logger.warning("xla_trace: could not start device trace",
                            exc_info=True)
            self._want = 0
            return
        self._prof = prof
        self.last_dir = out
        self._n, self._want, self._seen = self._want, 0, 0
        self._recaptured = set()
        self._wall_start = time.time()
        self._mono_start = time.perf_counter()
        self._active = True

    def stop(self):
        """Stop and finalize the current capture (no-op when idle).
        Returns the parsed summary dict, or None."""
        self._owner = None
        if not self._active:
            self._want = 0
            return None
        self._active = False
        prof, self._prof = self._prof, None
        try:
            import torch
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                self.last_dir, f"rank{self.rank}.pt.trace.json"))
        except Exception:  # noqa: BLE001
            _logger.warning("xla_trace: stop_trace failed", exc_info=True)
            return None
        wall_stop = time.time()
        steps = max(self._seen, 1)
        summary = parse_trace_dir(self.last_dir, self._op_map)
        if summary:
            self._op_map.update(summary["op_map"])
        meta = {
            "version": 1,
            "rank": self.rank,
            "steps": steps,
            "wall_start": self._wall_start,
            "wall_stop": wall_stop,
            "wall_elapsed_s": wall_stop - self._wall_start,
            "trace_dir": self.last_dir,
            "summary": summary,
            # Per-program phase maps (each node's scope path, in capture
            # order), so the offline diag CLI (--xla-trace) can
            # phase-attribute replayed device events.
            "op_map": self._op_map,
        }
        try:
            path = os.path.join(self.last_dir, META_FILENAME)
            tmp = f"{path}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(meta, f, indent=1, default=str)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001
            _logger.warning("xla_trace: could not write %s", META_FILENAME,
                            exc_info=True)
        self.captures += 1
        self.last_summary = summary
        metrics.XLA_TRACE_CAPTURES.inc()
        if summary:
            lanes = summary["lanes"]
            for phase, sec in summary["phases"].items():
                metrics.XLA_PHASE_SECONDS.labels(phase=phase).set(sec)
            for stage, sec in summary["stages"].items():
                if sec > 0.0:
                    metrics.WIRE_STAGE_SECONDS.labels(stage=stage).observe(
                        sec / steps / lanes)
            if summary.get("moe"):
                metrics.MOE_ALLTOALL_HIDDEN_FRAC.set(
                    summary["moe"]["hidden_frac"])
            if summary.get("exchange"):
                metrics.EXCHANGE_HIDDEN_FRAC.set(
                    summary["exchange"]["hidden_frac"])
        rec = recorder.get()
        if rec is not None:
            rec.record("xla_trace", name=self.last_dir or "",
                       extra={"steps": steps,
                              "total_s": summary["total_s"] if summary
                              else 0.0})
        return summary


# --------------------------------------------------------- module plumbing

_tracer = None


def install(config, rank=0, size=1):
    """Create the process tracer at init. Returns None — and leaves NO
    tracer/profiler state behind — unless ``HOROVOD_XPROF_STEPS`` arms a
    capture (``hvd.trace_steps`` creates one on demand later)."""
    global _tracer
    steps = int(getattr(config, "xprof_steps", 0))
    if steps <= 0:
        _tracer = None
        return None
    _tracer = StepTracer(diag_dir=getattr(config, "diag_dir", ""), rank=rank,
                         size=size)
    _tracer.arm(steps)
    return _tracer


def get():
    """The process tracer, or None when nothing ever armed one."""
    return _tracer


def uninstall():
    """Drop the tracer, stopping any still-active capture first."""
    global _tracer
    t, _tracer = _tracer, None
    if t is not None and t.active:
        try:
            t.stop()
        except Exception:  # noqa: BLE001
            _logger.debug("xla_trace: stop on uninstall failed",
                          exc_info=True)


def trace_steps(n, out_dir=None, rank=None):
    """Arm a one-shot capture of the next ``n`` steps (the programmatic
    form of ``HOROVOD_XPROF_STEPS``). Creates the tracer on demand;
    ``out_dir`` overrides the capture directory (default:
    ``HOROVOD_DIAG_DIR``, else the CWD); ``rank`` defaults to the
    session's. Returns the tracer."""
    global _tracer
    if _tracer is None:
        from .. import runtime
        diag_dir, size = out_dir, 1
        if runtime.is_initialized():
            st = runtime.live_state()
            diag_dir = diag_dir or getattr(st.config, "diag_dir", "")
            size = st.size
            rank = st.rank if rank is None else rank
        _tracer = StepTracer(diag_dir=diag_dir or "", rank=rank or 0,
                             size=size)
    _tracer.arm(n, out_dir)
    return _tracer
