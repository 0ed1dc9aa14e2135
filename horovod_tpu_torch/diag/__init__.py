"""Collective flight recorder, hang diagnosis and the phase trace.

Counterpart of horovod_tpu/diag/, module for module:

- ``recorder.FlightRecorder``: an always-on, bounded-memory, lock-free
  per-rank ring buffer recording every collective's lifecycle (enqueue,
  dispatch, wire end) plus step marks. Off the steady-state critical
  path by construction: one GIL-atomic counter increment and one tuple
  store per event, no locks anywhere.
- ``recorder.HangWatchdog``: created only when
  ``HOROVOD_STALL_TIMEOUT_SECONDS > 0`` — dumps a durable post-mortem
  (``flight-rank<N>.json`` + all-thread stacks) for any exchange in
  flight past the timeout, publishes per-rank progress beacons through
  the session's store, and (process 0) emits a desync report naming
  exactly which ranks entered the stalled collective and which are
  missing.
- ``xla_trace.StepTracer``: on-demand ``torch.profiler`` capture of N
  steps (``hvd.trace_steps(n)`` / ``HOROVOD_XPROF_STEPS``), parsed into
  per-phase device time via the ``hvd_*`` ranges of the step, the
  exchange, the MoE layer and the serve programs, replayed CUDA graphs
  included (their per-program phase maps).
- ``sentry.PerfSentry``: an EMA per-signature step-time/MFU baseline
  (``HOROVOD_PERF_SENTRY=1``) that flags regressions, records them in
  the flight ring, and auto-arms one trace window.
- ``python -m horovod_tpu_torch.diag``: merges per-rank dumps into one
  clock-aligned Chrome trace and prints a critical-path report
  (per-step phase breakdown, per-rank skew, slowest-rank ranking);
  ``--xla-trace`` splices a device capture into the same clock.
"""

from .recorder import (FlightRecorder, HangWatchdog, dump_post_mortem, get,
                       install, start_watchdog, uninstall)
from .sentry import PerfSentry
from .xla_trace import StepTracer, parse_trace_dir, trace_steps

__all__ = ["FlightRecorder", "HangWatchdog", "get", "install", "uninstall",
           "start_watchdog", "dump_post_mortem", "PerfSentry", "StepTracer",
           "parse_trace_dir", "trace_steps"]
