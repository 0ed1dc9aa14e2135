"""The profiler's raw trace (kineto's Chrome trace JSON), read by the
benchmark's own code: device intervals, the traced window, time by
kernel name, the longest idle gaps and, for an eager step, the phase of
each device event.

Times in a trace are microseconds; everything returned here is in
seconds."""

import json
import os
import re

from . import arith

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function") + LAUNCH_CATS
PHASE_RE = re.compile(r"^hvd_(forward|backward|exchange|optimizer|guard"
                      r"|dispatch|expert|combine)$")
US = 1e-6


def trace_files(trace_dir):
    for dirpath, _, names in os.walk(trace_dir):
        for name in sorted(names):
            if name.endswith(".trace.json"):
                yield os.path.join(dirpath, name)


def load(trace_dir):
    """Every complete (``ph: X``) event of every trace file under
    ``trace_dir``."""
    events = []
    for path in trace_files(trace_dir):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        events += [e for e in doc.get("traceEvents", [])
                   if e.get("ph") == "X" and "ts" in e]
    return events


def _span(e):
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur") or 0.0)


def short_name(name, width=160):
    """A kernel's name without its argument list (the parenthesised
    group that closes it), cut to ``width`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:width].rstrip()


def device_events(events):
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def window(events):
    """``(start, end)`` in microseconds of the traced window: from the
    profiler's step annotation (or the first host event) to the later of
    its end and the last device event's."""
    steps = [_span(e) for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("ProfilerStep#")]
    dev = [_span(e) for e in device_events(events)]
    if not dev:
        return None
    if steps:
        start = min(s for s, _ in steps)
        end = max(max(e for _, e in steps), max(e for _, e in dev))
    else:
        host = [_span(e) for e in events if e.get("cat") in HOST_CATS]
        start = min(s for s, _ in host + dev)
        end = max(e for _, e in dev)
    return start, end


def busy(events, win):
    """Seconds of ``win`` in which some kernel, copy or set ran on some
    stream of the device."""
    spans = arith.clip([_span(e) for e in device_events(events)], *win)
    return arith.length(arith.merge(spans)) * US


def time_by_name(events):
    """``{device event name: seconds}``."""
    out = {}
    for e in device_events(events):
        name = str(e.get("name", ""))
        out[name] = out.get(name, 0.0) + float(e.get("dur") or 0.0) * US
    return out


def matching_time(events, pattern, exclude=None):
    """Seconds of device events whose name ``pattern`` (a compiled
    regex) finds and ``exclude`` does not."""
    total = 0.0
    for e in device_events(events):
        name = str(e.get("name", ""))
        if pattern.search(name) and not (exclude and exclude.search(name)):
            total += float(e.get("dur") or 0.0)
    return total * US


def idle_gaps(events, win, k=10):
    """The ``k`` longest stretches of ``win`` with nothing on the device,
    each named by the host operation that was running at its middle (the
    innermost, by latest start, of the host events that cover it)."""
    merged = arith.merge(arith.clip([_span(e) for e in device_events(events)],
                                    *win))
    gaps, at = [], win[0]
    for s, e in merged:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if win[1] > at:
        gaps.append((at, win[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(_span(e), str(e.get("name", ""))) for e in events
            if e.get("cat") in HOST_CATS
            and not str(e.get("name", "")).startswith("ProfilerStep#")]
    out = []
    for s, e in gaps[:k]:
        mid = (s + e) / 2
        covering = [(span[0], name) for span, name in host
                    if span[0] <= mid <= span[1]]
        label = max(covering)[1] if covering else "no host op"
        out.append([label, (e - s) * US])
    return out


def phase_ms(summary, phase, steps):
    """Device milliseconds a step that the program's phase trace
    (``StepTracer.last_summary``) gives ``phase``; None where it gives
    none."""
    sec = (summary or {}).get("phases", {}).get(phase, 0.0)
    return sec * 1e3 / steps if sec > 0 else None


def phases_by_launch(events):
    """``[(phase, start, end)]`` of each device event of an eager step:
    the event's launch (the runtime or driver call with its correlation
    id) joined by time to the innermost ``hvd_<phase>`` range around it
    on any thread, or ``other``. Replayed graphs launch all their
    kernels from one call, so this join does not apply to them."""
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launches[corr] = float(e["ts"])
    ranges = sorted((_span(e) + (PHASE_RE.match(str(e.get("name"))).group(1),)
                     for e in events if e.get("cat") == "user_annotation"
                     and PHASE_RE.match(str(e.get("name", "")))),
                    key=lambda r: r[0])
    out = []
    for e in device_events(events):
        s, t = _span(e)
        at = launches.get((e.get("args") or {}).get("correlation"))
        phase = "other"
        if at is not None:
            inner = [r for r in ranges if r[0] <= at <= r[1]]
            if inner:
                phase = max(inner, key=lambda r: r[0])[2]
        out.append((phase, s, t))
    return out


def exposed(attributed, phase):
    """Seconds of ``phase``'s device intervals in which no device event
    of another phase runs on any stream."""
    mine = arith.merge([(s, t) for p, s, t in attributed if p == phase])
    rest = arith.merge([(s, t) for p, s, t in attributed if p != phase])
    return (arith.length(mine) - arith.intersection(mine, rest)) * US
