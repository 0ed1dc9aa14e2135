"""Deterministic chaos-injection harness for the step-integrity guard.

Counterpart of horovod_tpu/guard/inject.py: the same grammar and
occurrence bookkeeping, with torch tensors at the hooks. The compiled
step's ``nan`` point is :meth:`Injector.on_step_nan`: a captured graph
runs no host code, so the step asks before each call and sets a device
flag its program reads (ops/step_program.py).

Every defense in :mod:`horovod_tpu.guard` exists for faults that are
vanishingly rare in small test runs — a NaN micro-step, a corrupted wire
bucket, a transient dispatch failure. This module makes them *orderable*:
``HOROVOD_GUARD_INJECT`` describes exactly which fault to fire, where and
when, and the engine's hooks fire it deterministically, so the chaos
suite (tests/test_torch_guard.py, chip_smoke.py's guard phase) can assert exact
outcomes ("exactly one skipped step", "exactly one retry").

Spec grammar — ``;``-separated specs, each ``kind,key=value,...``:

==========  ===========================================================
``nan``     Replace the first element of a matching enqueued tensor
            with NaN (``name=`` substring match, default every tensor):
            an eager-engine submission, a DistributedOptimizer bucket
            (``<optimizer>.grads.bucket<b>``), or, matching a compiled
            step's name, that step's backward seeded with NaN.
``corrupt`` Overwrite the leading bytes of this process's fused wire
            row with ``0xFF`` before dispatch (an SDC on the wire; for
            IEEE floats that is a NaN payload). With a ``name=`` that
            matches a compiled step's name, instead perturbs this
            rank's parameters before the program runs — a *finite* SDC
            that evades the in-graph health gate and is caught by the
            divergence probe (the compiled wire is in-graph; there are
            no host rows to overwrite).
``fail``    Raise :class:`~horovod_tpu.exceptions.TransientCollectiveError`
            at dispatch (``op=`` substring match, default every op).
``delay``   Sleep ``seconds=`` (default 0.1) before dispatch.
==========  ===========================================================

Common keys: ``step=S`` — fire at the S-th (0-based) matching occurrence
of the hook (for a per-step tensor name, occurrence index == training
step); ``count=C`` — fire for C consecutive occurrences from ``step``
(default 1); ``rank=R`` — fire only on rank R (default: every rank). Occurrences are counted per spec per matched name, so
injection is reproducible run to run regardless of thread timing.

Example::

    HOROVOD_GUARD_INJECT="nan,name=hvd.grads.0,step=2,rank=0;fail,count=1"

Inert by default: with no spec, :func:`install` leaves no injector and
the engine hooks stay ``None``-guarded attribute reads.
"""

import threading
import time

import torch

from .. import metrics
from ..exceptions import TransientCollectiveError
from ..utils.logging import get_logger

_logger = get_logger()

_KINDS = ("nan", "corrupt", "fail", "delay")


class InjectionSpec:
    """One parsed fault spec with its per-name occurrence counters."""

    __slots__ = ("kind", "name", "op", "step", "count", "rank", "seconds",
                 "_seen", "fired")

    def __init__(self, kind, name="", op="", step=0, count=1, rank=None,
                 seconds=0.1):
        if kind not in _KINDS:
            raise ValueError(
                f"unknown injection kind {kind!r} (expected one of {_KINDS})")
        self.kind = kind
        self.name = name          # substring match on tensor name
        self.op = op              # substring match on collective op
        self.step = int(step)     # first matching occurrence to fire at
        self.count = max(int(count), 1)
        self.rank = None if rank is None else int(rank)
        self.seconds = float(seconds)
        self._seen = {}           # match key -> occurrences observed
        self.fired = 0

    def _fire(self, key):
        """Occurrence bookkeeping: True when this observation of ``key``
        falls inside the [step, step+count) firing window."""
        n = self._seen.get(key, 0)
        self._seen[key] = n + 1
        return self.step <= n < self.step + self.count

    def describe(self):
        return {"kind": self.kind, "name": self.name, "op": self.op,
                "step": self.step, "count": self.count, "rank": self.rank}


def parse(spec_string):
    """Parse ``HOROVOD_GUARD_INJECT`` into a list of InjectionSpecs.
    Raises ValueError on malformed specs — a chaos run with a typo'd
    spec silently injecting nothing would report false health."""
    specs = []
    for part in (spec_string or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = [f.strip() for f in part.split(",")]
        kind, kw = fields[0], {}
        for f in fields[1:]:
            if "=" not in f:
                raise ValueError(f"injection spec field {f!r} is not "
                                 f"key=value (in {part!r})")
            k, v = f.split("=", 1)
            if k in ("step", "count", "rank"):
                kw[k] = int(v)
            elif k == "seconds":
                kw[k] = float(v)
            elif k in ("name", "op"):
                kw[k] = v
            else:
                raise ValueError(f"unknown injection key {k!r} "
                                 f"(in {part!r})")
        specs.append(InjectionSpec(kind, **kw))
    return specs


class Injector:
    """Process-wide fault injector driven by the engine's hooks.

    Thread-safe: hooks can fire from the application thread, the
    completion thread and the control-plane ticker; the occurrence
    counters advance under one lock so determinism survives threading.
    """

    def __init__(self, specs, process_index=0):
        self._specs = list(specs)
        self._pid = int(process_index)
        self._lock = threading.Lock()
        self._flight = None  # set lazily; diag may install after us

    def _record(self, spec, detail):
        metrics.GUARD_INJECTIONS.labels(kind=spec.kind).inc()
        from .. import diag
        fr = diag.get()
        if fr is not None:
            fr.record("inject", detail.get("name", ""),
                      detail.get("op", ""), extra={"kind": spec.kind,
                                                   **detail})
        _logger.warning("chaos injection fired: %s %s", spec.kind, detail)

    def _matches_rank(self, spec):
        return spec.rank is None or spec.rank == self._pid

    # ------------------------------------------------------------ hooks

    def on_enqueue(self, name, tensor):
        """``nan`` injection point: maybe poison an enqueued tensor.
        Returns the (possibly replaced) tensor; never mutates the
        caller's array."""
        with self._lock:
            for spec in self._specs:
                if spec.kind != "nan" or not self._matches_rank(spec):
                    continue
                if spec.name and spec.name not in name:
                    continue
                if not spec._fire(name):
                    continue
                if not (tensor.numel() and tensor.is_floating_point()):
                    continue  # non-float tensors can't carry NaN
                arr = tensor.detach().clone()
                arr.view(-1)[0] = float("nan")
                spec.fired += 1
                self._record(spec, {"name": name})
                return arr
        return tensor

    def on_rows(self, rows, names=()):
        """``corrupt`` injection point: maybe overwrite the leading bytes
        of this process's fused wire rows (simulated silent data
        corruption between fill and dispatch)."""
        with self._lock:
            for spec in self._specs:
                if spec.kind != "corrupt" or not self._matches_rank(spec):
                    continue
                if spec.name and not any(spec.name in n for n in names):
                    continue
                if not spec._fire("rows"):
                    continue
                rows = rows.detach().clone()
                raw = rows.view(-1).view(torch.uint8)
                raw[:min(8, raw.numel())] = 0xFF
                spec.fired += 1
                self._record(spec, {"name": ",".join(names)[:80]})
                return rows
        return rows

    def on_step(self, name):
        """``corrupt`` injection point for the compiled-step path: the
        fused wire lives in-graph there (no host rows to overwrite), so
        ``CompiledTrainStep`` asks before dispatch whether to perturb
        this rank's copy of the parameters instead — a finite-valued SDC
        that deliberately slips past the in-graph health gate and
        exercises the cross-replica divergence probe. Fires only for
        ``corrupt`` specs with an explicit ``name=`` matching the step
        name, so legacy unnamed corrupt specs stay eager-wire-only."""
        with self._lock:
            for spec in self._specs:
                if spec.kind != "corrupt" or not self._matches_rank(spec):
                    continue
                if not spec.name or spec.name not in name:
                    continue
                if not spec._fire(("step", name)):
                    continue
                spec.fired += 1
                self._record(spec, {"name": name, "op": "step_program"})
                return True
        return False

    def on_step_nan(self, name):
        """``nan`` injection point for the compiled step: True when a
        ``nan`` spec whose ``name=`` matches the step's name fires at
        this call. The step then seeds its backward with NaN through its
        device seed (every gradient of this rank NaN, as a poisoned
        submission makes the reduced buffer NaN on every rank)."""
        with self._lock:
            for spec in self._specs:
                if spec.kind != "nan" or not self._matches_rank(spec):
                    continue
                if not spec.name or spec.name not in name:
                    continue
                if not spec._fire(("step", name)):
                    continue
                spec.fired += 1
                self._record(spec, {"name": name, "op": "step_program"})
                return True
        return False

    def on_dispatch(self, op="allreduce"):
        """``fail`` / ``delay`` injection point, called immediately
        before a wire dispatch. May sleep or raise
        TransientCollectiveError."""
        fire_fail = fire_delay = None
        with self._lock:
            for spec in self._specs:
                if not self._matches_rank(spec):
                    continue
                if spec.op and spec.op not in op:
                    continue
                if spec.kind == "fail" and spec._fire(op):
                    spec.fired += 1
                    fire_fail = spec
                elif spec.kind == "delay" and spec._fire(op):
                    spec.fired += 1
                    fire_delay = spec
        if fire_delay is not None:
            self._record(fire_delay, {"op": op,
                                      "seconds": fire_delay.seconds})
            time.sleep(fire_delay.seconds)
        if fire_fail is not None:
            self._record(fire_fail, {"op": op})
            raise TransientCollectiveError(
                f"injected transient failure on {op} "
                f"(HOROVOD_GUARD_INJECT)")


# ------------------------------------------------ process-wide installation

_injector = None


def install(config, process_index=0):
    """Create (or replace) the process injector from config. Returns None
    — no hooks — when ``HOROVOD_GUARD_INJECT`` is empty."""
    global _injector
    spec = getattr(config, "guard_inject", "") or ""
    if not spec.strip():
        _injector = None
        return None
    _injector = Injector(parse(spec), process_index=process_index)
    return _injector


def get():
    """The process injector, or None when chaos injection is off."""
    return _injector


def uninstall():
    global _injector
    _injector = None
