"""Perf-regression sentry: a black-box recorder for performance.

Counterpart of horovod_tpu/diag/sentry.py: the same comparator,
baseline file and verdicts. Observability catches regressions only if
someone is looking. The sentry (``HOROVOD_PERF_SENTRY=1``) watches the
quantities the telemetry already measures — per-step wall time and MFU
— against a rolling per-signature EMA baseline (model digest x batch x
world x zero_stage) persisted as ``perf-baseline.json`` under
``HOROVOD_METRICS_DIR``, so a nightly bench run is compared against
*yesterday's* steady state, not just its own warmup. It is fed by
``callbacks.TelemetryCallback`` (train steps) and the serve engine
(prefill and decode calls). On a regression beyond
``HOROVOD_PERF_SENTRY_THRESHOLD`` (default 25%) it:

- increments ``hvd_perf_regressions_total{kind=step_time|mfu}``,
- records a ``perf_regression`` flight-recorder event, and
- auto-arms ONE device-trace window (:mod:`.xla_trace`, the torch
  profiler) per signature per session, so the slow step's phase
  breakdown is on disk before anyone asks.

Inert by default: with the knob off, ``install`` returns None and no
baseline file, thread or state exists — the guard/watchdog contract.
"""

import json
import os

from .. import metrics
from ..utils.logging import get_logger
from . import recorder, xla_trace

_logger = get_logger()

BASELINE_FILENAME = "perf-baseline.json"
BASELINE_VERSION = 1

#: EMA smoothing for the rolling baseline: ~10 steps of memory, so a
#: sustained slowdown keeps firing for several steps before the baseline
#: absorbs it (and a one-step blip fires at most once).
EMA_ALPHA = 0.2
#: Observations of a signature before comparisons start — steady state,
#: not compile/warmup steps, defines the baseline.
WARMUP_STEPS = 5
#: Steps captured by the auto-armed trace window on first regression.
AUTO_TRACE_STEPS = 4


class PerfSentry:
    """Single-training-thread EMA comparator over (step time, MFU) keyed
    by a workload signature string."""

    def __init__(self, threshold=0.25, baseline_dir="", rank=0,
                 warmup=WARMUP_STEPS, alpha=EMA_ALPHA, auto_trace=True):
        self.threshold = float(threshold)
        self.baseline_dir = baseline_dir
        self.rank = rank
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self.auto_trace = auto_trace
        self.regressions = 0
        self._baselines = {}
        self._auto_traced = set()
        self._observes_since_save = 0
        self._load()

    # ---------------------------------------------------------- persistence

    def _path(self):
        if not self.baseline_dir:
            return None
        return os.path.join(self.baseline_dir,
                            f"perf-baseline-rank{self.rank}.json"
                            if self.rank else BASELINE_FILENAME)

    def _load(self):
        path = self._path()
        if not path or not os.path.exists(path):
            return
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            sigs = doc.get("signatures", {})
            if isinstance(sigs, dict):
                self._baselines = {
                    str(k): {"step_ema": float(v["step_ema"]),
                             "mfu_ema": (float(v["mfu_ema"])
                                         if v.get("mfu_ema") else None),
                             "n": int(v.get("n", 0))}
                    for k, v in sigs.items() if "step_ema" in v}
        except Exception:  # noqa: BLE001 - corrupt baseline = cold start
            _logger.warning("perf sentry: ignoring unreadable baseline %s",
                            path)
            self._baselines = {}

    def flush(self):
        """Persist the baselines (atomic write); no-op without a dir."""
        path = self._path()
        if not path:
            return
        try:
            os.makedirs(self.baseline_dir, exist_ok=True)
            tmp = f"{path}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": BASELINE_VERSION,
                           "signatures": self._baselines}, f, indent=1)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 - telemetry must never kill work
            _logger.warning("perf sentry: baseline write failed",
                            exc_info=True)

    # ------------------------------------------------------------- observe

    def observe(self, signature, step_seconds, mfu=None):
        """Fold one step into the baseline and compare. Returns a verdict
        dict when a regression fired, else None."""
        sig = str(signature)
        step_seconds = float(step_seconds)
        if step_seconds <= 0.0:
            return None
        b = self._baselines.get(sig)
        if b is None:
            self._baselines[sig] = {"step_ema": step_seconds,
                                    "mfu_ema": float(mfu) if mfu else None,
                                    "n": 1}
            return None
        verdict = None
        if b["n"] >= self.warmup:
            if step_seconds > b["step_ema"] * (1.0 + self.threshold):
                verdict = self._fire("step_time", sig, step_seconds,
                                     b["step_ema"])
            elif (mfu and b.get("mfu_ema")
                  and float(mfu) < b["mfu_ema"] * (1.0 - self.threshold)):
                verdict = self._fire("mfu", sig, float(mfu), b["mfu_ema"])
        a = self.alpha
        b["step_ema"] += a * (step_seconds - b["step_ema"])
        if mfu:
            b["mfu_ema"] = (float(mfu) if b.get("mfu_ema") is None
                            else b["mfu_ema"] + a * (float(mfu)
                                                     - b["mfu_ema"]))
        b["n"] += 1
        self._observes_since_save += 1
        if self._observes_since_save >= 50:
            self._observes_since_save = 0
            self.flush()
        return verdict

    def _fire(self, kind, sig, value, baseline):
        self.regressions += 1
        metrics.PERF_REGRESSIONS.labels(kind=kind).inc()
        verdict = {"kind": kind, "signature": sig, "value": value,
                   "baseline": baseline,
                   "ratio": value / baseline if baseline else 0.0}
        rec = recorder.get()
        if rec is not None:
            rec.record("perf_regression", name=sig, op=kind,
                       extra=verdict)
        _logger.warning(
            "perf sentry: %s regression on %s — %.4g vs baseline %.4g "
            "(threshold %.0f%%)", kind, sig, value, baseline,
            self.threshold * 100)
        if self.auto_trace and sig not in self._auto_traced:
            # One trace window per signature per session: the regressed
            # steps' phase breakdown lands under the diag dir without
            # anyone re-running the job.
            self._auto_traced.add(sig)
            try:
                xla_trace.trace_steps(AUTO_TRACE_STEPS, rank=self.rank)
            except Exception:  # noqa: BLE001
                _logger.debug("perf sentry: auto-trace arm failed",
                              exc_info=True)
        return verdict


# --------------------------------------------------------- module plumbing

_sentry = None


def install(config, rank=0):
    """Create the process sentry. Returns None — no state at all — unless
    ``HOROVOD_PERF_SENTRY`` is on."""
    global _sentry
    if not getattr(config, "perf_sentry", False):
        _sentry = None
        return None
    _sentry = PerfSentry(
        threshold=getattr(config, "perf_sentry_threshold", 0.25),
        baseline_dir=getattr(config, "metrics_dir", ""),
        rank=rank)
    return _sentry


def get():
    """The process sentry, or None when disabled."""
    return _sentry


def uninstall():
    """Persist and drop the sentry."""
    global _sentry
    s, _sentry = _sentry, None
    if s is not None:
        try:
            s.flush()
        except Exception:  # noqa: BLE001
            _logger.debug("perf sentry: flush on uninstall failed",
                          exc_info=True)
