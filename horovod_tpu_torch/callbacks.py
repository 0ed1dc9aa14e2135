"""Training-loop callbacks: the step telemetry.

Counterpart of horovod_tpu/callbacks.py, carrying its callback protocol
(:class:`Callback`) and :class:`TelemetryCallback`: the step marks in
the flight recorder, the step and examples/s gauges, the straggler skew
over ``allgather`` every ``skew_interval`` steps, MFU, the perf
sentry's feed, the eager loop's tick of an armed phase trace and the
flight recorder's phase gauges (``hvd_diag_phase_seconds``). The
autoscaler signal goes through elastic/policy.py's ``write_signal``. The
other callbacks (broadcast, metric averaging, learning-rate schedules,
elastic commits) come with ROADMAP.md, Queue 1 item 15.
"""

import time

import numpy as np
import torch

from . import metrics
from .diag import recorder as diag
from .ops.collectives import allgather
from .runtime import is_initialized, rank, size


class Callback:
    """Minimal Keras-style callback protocol."""

    params = None
    model = None

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_batch_begin(self, batch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class TelemetryCallback(Callback):
    """Per-step training telemetry into the process-wide metrics registry
    (metrics.py; no reference analog — the fork's observability stops at
    per-collective counters).

    Every step: records the step's wall time (``hvd_step_seconds``
    histogram, ``hvd_steps_total``) and the examples/sec of the most
    recent step (``hvd_examples_per_sec``; batch size taken from the
    constructor, else from ``params["batch_size"]``).

    Every ``skew_interval`` steps: allgathers each rank's latest step time
    and exports the straggler skew — max/median of the per-rank times
    (``hvd_step_time_skew``, plus the raw ``hvd_step_seconds_max`` /
    ``hvd_step_seconds_median`` gauges). A skew near 1.0 means a balanced
    mesh; sustained values above ~1.2 name a straggling host long before
    stall warnings would (docs/troubleshooting.md). The allgather is a
    collective: every rank runs this callback every step, so the sample
    cadence agrees globally and the op negotiates like any other eager
    collective. ``skew_interval=0`` disables the skew sampling.

    With ``dataset=`` (anything exposing ``take_wait()``, as the JAX
    package's ``hvd.data.DistributedDataset`` does; ROADMAP.md, Queue 1
    item 14), each step also exports the input-wait
    share of the step's wall time (``hvd_data_stall_ratio``) — data-wait
    reported alongside step time, so a slow step is attributable to
    input vs communication at a glance (docs/observability.md).

    When ``policy_dir`` is set (default: the supervisor-provided
    ``HOROVOD_ELASTIC_POLICY_DIR``), the same telemetry also feeds the
    autoscaler: a throttled per-rank JSON signal file (step count, step
    time, skew, stall ratio, prefetch occupancy) dropped where the
    supervisor's autoscale policy reads it (elastic/policy.py).

    With ``compiled_step=`` (a :class:`~horovod_tpu_torch.CompiledTrainStep`),
    the policy signal additionally carries the compiled hot loop's
    health — the step-program cache hit rate and fallback count
    (docs/performance.md "Compiled hot loop") — so the supervisor can
    see a resize's recompile cost land and drain; the
    ``hvd_step_program_*`` gauges themselves are kept fresh by the step
    object on every call."""

    def __init__(self, batch_size=None, skew_interval=50, dataset=None,
                 policy_dir=None, signal_interval=0.5, compiled_step=None):
        self.batch_size = batch_size
        self.skew_interval = skew_interval
        self.dataset = dataset
        self.compiled_step = compiled_step
        if policy_dir is None:
            from .config import Config
            policy_dir = Config.from_env().elastic_policy_dir
        self.policy_dir = policy_dir
        self.signal_interval = signal_interval
        self._t0 = None
        self._steps = 0
        self._last_skew = None
        self._last_stall = None
        self._last_wire_share = None
        self._last_signal_t = float("-inf")
        self._last_mfu = None
        self._peak_flops = None  # lazy: resolved on first step

    def on_batch_begin(self, batch, logs=None):
        self._t0 = time.perf_counter()

    def on_batch_end(self, batch, logs=None):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._steps += 1
        metrics.STEPS_TOTAL.inc()
        metrics.STEP_SECONDS.observe(dt)
        fr = diag.get()
        if fr is not None:
            # Step marks give the flight recorder (and the diag CLI's
            # critical-path report) the denominator for per-step phase
            # attribution.
            fr.record("step", extra={"dt": dt, "step": self._steps})
        batch_size = self.batch_size
        if batch_size is None and self.params:
            batch_size = self.params.get("batch_size")
        if batch_size and dt > 0:
            metrics.EXAMPLES_PER_SEC.set(batch_size / dt)
        self._observe_perf(dt, batch_size)
        if self.dataset is not None and hasattr(self.dataset, "take_wait"):
            # The batch fetch normally happens OUTSIDE the begin/end
            # window (the loop fetches, then runs the timed step), so
            # the full step wall time is wait + dt and the stall share
            # is wait / (wait + dt) — not wait / dt, which saturates at
            # 1.0 the moment waiting matches compute.
            wait = self.dataset.take_wait()
            stall = wait / (wait + dt) if wait + dt > 0 else 0.0
            metrics.DATA_STALL_RATIO.set(stall)
            self._last_stall = stall
        if (self.skew_interval and self._steps % self.skew_interval == 0
                and is_initialized()):
            # One float64 per rank; a rounding error of wire cost next to
            # the steps it profiles.
            times = allgather(torch.tensor([dt], dtype=torch.float64),
                              name="telemetry.step_time").cpu().numpy()
            med = float(np.median(times))
            mx = float(np.max(times))
            metrics.STEP_SKEW_MAX.set(mx)
            metrics.STEP_SKEW_MEDIAN.set(med)
            skew = mx / med if med > 0 else 1.0
            metrics.STEP_SKEW.set(skew)
            self._last_skew = skew
            self._export_phase_attribution()
        if self.policy_dir:
            self._write_policy_signal(dt)

    def _observe_perf(self, dt, batch_size):
        """Live MFU + perf-regression sentry feed, every step.

        MFU needs a compiled step (its FLOPs, counted on its warm-up
        call) and a known per-chip peak (hardware table, or HOROVOD_PEAK_FLOPS
        on hosts the table doesn't know); without either the gauge stays
        untouched and the sentry watches step time alone. Both the
        sentry and the tracer are inert-by-default singletons — the
        whole method is two dict lookups when nothing is enabled."""
        from .diag import sentry as _sentry
        from .diag import xla_trace as _xla_trace
        cs = self.compiled_step
        if cs is None:
            # Eager loops have no compiled-step tick source; pace any
            # armed device-trace capture from the step cadence here.
            # (CompiledTrainStep ticks itself and owner-locks the
            # tracer, so this never double-counts a compiled loop.)
            tr = _xla_trace.get()
            if tr is not None:
                tr.tick(owner=self)
        world = size() if is_initialized() else 1
        mfu = None
        flops = float(getattr(cs, "flops_per_step", 0.0) or 0.0)\
            if cs is not None else 0.0
        if flops and dt > 0:
            if self._peak_flops is None:
                from . import hardware, runtime
                st = runtime.live_state() if is_initialized() else None
                self._peak_flops = hardware.peak_flops_per_chip(
                    st.config if st else None,
                    st.device if st else None)
            if self._peak_flops > 0:
                mfu = flops / max(world, 1) / (dt * self._peak_flops)
                metrics.STEP_MFU.set(mfu)
                self._last_mfu = mfu
        s = _sentry.get()
        if s is not None:
            sig = (getattr(cs, "perf_signature", "eager")
                   if cs is not None else "eager")
            s.observe(f"{sig}|b{batch_size or 0}|w{world}", dt, mfu)

    def _export_phase_attribution(self):
        """Flight-recorder phase totals (wire / readback / input) into the
        ``hvd_diag_phase_seconds`` gauges, sampled on the skew cadence —
        the same per-step attribution the diag CLI reports, live, and the
        autoscale policy's wire-share signal source."""
        fr = diag.get()
        if fr is None:
            return
        totals = fr.phase_totals()
        for phase, key in (("wire", "wire_s"), ("readback", "readback_s"),
                           ("input", "input_s")):
            metrics.DIAG_PHASE_SECONDS.labels(phase=phase).set(totals[key])
        step_s = totals["step_s"]
        self._last_wire_share = (min(totals["wire_s"] / step_s, 1.0)
                                 if step_s > 0 else None)

    def _write_policy_signal(self, dt):
        """Throttled autoscaler signal drop (elastic/policy.py). Pure
        local file I/O — never a collective, so a rank mid-recovery or
        mid-departure cannot be wedged by its telemetry."""
        now = time.time()
        if now - self._last_signal_t < self.signal_interval:
            return
        self._last_signal_t = now
        occupancy = None
        if self.dataset is not None and hasattr(self.dataset,
                                                "prefetch_occupancy"):
            occupancy = self.dataset.prefetch_occupancy()
        cs = self.compiled_step
        # Most recent trace capture's exchange-overlap fraction (None
        # until a capture ran): a LOW value at a high wire share tells
        # the policy the job is comm-bound with the wire exposed —
        # retune HOROVOD_EXCHANGE_BUCKETS before buying more workers
        # (docs/performance.md "Bucketed backward/exchange overlap").
        exchange_hidden = None
        from .diag import xla_trace as _xla_trace
        tr = _xla_trace.get()
        if tr is not None and tr.last_summary:
            block = tr.last_summary.get("exchange")
            if block:
                exchange_hidden = block["hidden_frac"]
        from .elastic import policy as _policy
        _policy.write_signal(self.policy_dir,
                             rank() if is_initialized() else 0,
                             {"rank": rank() if is_initialized() else 0,
                              "time": now, "step": self._steps,
                              "step_seconds": dt,
                              "skew": self._last_skew,
                              "stall": self._last_stall,
                              "occupancy": occupancy,
                              "wire_share": self._last_wire_share,
                              "mfu": self._last_mfu,
                              "exchange_hidden_frac": exchange_hidden,
                              "compiled_hit_rate":
                                  cs.cache_hit_rate if cs else None,
                              "compiled_fallbacks":
                                  cs.fallback_steps if cs else None})
