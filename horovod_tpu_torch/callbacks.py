"""Training-loop callbacks: telemetry, metric averaging, LR schedules,
warmup, elastic commits and the guard.

Counterpart of horovod_tpu/callbacks.py (reference: the Keras
callbacks of horovod/_keras/callbacks.py): the callback protocol
(:class:`Callback`); :class:`TelemetryCallback` (the step marks in the
flight recorder, the step and examples/s gauges, the straggler skew
over ``allgather`` every ``skew_interval`` steps, MFU, the perf
sentry's feed, the eager loop's tick of an armed phase trace, the flight
recorder's phase gauges and the autoscaler signal through
elastic/policy.py's ``write_signal``); :class:`BroadcastGlobalVariablesCallback`,
:class:`MetricAverageCallback`, :class:`ElasticStateCallback`,
:class:`GuardCallback`, :class:`LearningRateRescaleCallback`,
:class:`LearningRateScheduleCallback` and
:class:`LearningRateWarmupCallback`. The learning-rate callbacks work on
a torch optimizer's ``param_groups`` or any object with an ``lr``
attribute; a tensor ``lr`` is filled in place, so a captured step
(ops/step_program.py) reads the new rate on its next replay.
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


class _AttrBackend:
    """get/set hyperparameters on optimizer-like objects: plain
    attribute holders and torch optimizers (param_groups). A value held
    as a tensor is filled in place (a captured CUDA graph reads that
    storage), any other is replaced."""

    def __init__(self, optimizer):
        self.opt = optimizer

    def _groups(self, name):
        groups = getattr(self.opt, "param_groups", None)
        if groups is not None and groups and name in groups[0]:
            return groups
        return None

    def has(self, name):
        return self._groups(name) is not None or hasattr(self.opt, name)

    def get(self, name):
        groups = self._groups(name)
        value = (groups[0][name] if groups is not None
                 else getattr(self.opt, name))
        return float(value) if torch.is_tensor(value) else value

    def set(self, name, value):
        groups = self._groups(name)
        holders = groups if groups is not None else [None]
        for g in holders:
            old = g[name] if g is not None else getattr(self.opt, name)
            if torch.is_tensor(old):
                with torch.no_grad():
                    old.fill_(value)
            elif g is not None:
                g[name] = value
            else:
                setattr(self.opt, name, value)


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast initial state from root_rank at train begin
    (reference: _keras/callbacks.py:20-31). ``get_state()`` returns a
    module, a state_dict or (name, tensor) pairs, broadcast in place;
    ``set_state(state)`` is called after, when given."""

    def __init__(self, root_rank=0, get_state=None, set_state=None):
        self.root_rank = root_rank
        self._get_state = get_state
        self._set_state = set_state

    def on_train_begin(self, logs=None):
        if self._get_state is None:
            return
        from .optimizers import broadcast_parameters
        state = self._get_state()
        params = (state.state_dict() if isinstance(state, torch.nn.Module)
                  else state)
        broadcast_parameters(params, root_rank=self.root_rank)
        if self._set_state is not None:
            self._set_state(state)


class MetricAverageCallback(Callback):
    """Allreduce-average the epoch's metrics across ranks so logs agree on
    every worker (reference: _keras/callbacks.py:33-67)."""

    def on_epoch_end(self, epoch, logs=None):
        from . import allreduce
        logs = logs if logs is not None else {}
        reduced = {}
        for metric, value in sorted(logs.items()):
            if isinstance(value, (int, float, np.floating, np.integer)):
                reduced[metric] = float(allreduce(
                    torch.tensor(float(value), dtype=torch.float64),
                    average=True, name=f"metric.{metric}"))
        logs.update(reduced)


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


class ElasticStateCallback(Callback):
    """Commit elastic training state at a fixed batch cadence
    (:meth:`horovod_tpu_torch.elastic.State.commit`), bounding how much
    work a worker-failure rollback can lose to ``commit_every`` batches
    (upstream analog: Elastic Horovod's ``CommitStateCallback``). An
    end-of-epoch commit always happens."""

    def __init__(self, state, commit_every=10):
        self.state = state
        self.commit_every = max(int(commit_every), 1)
        self._batches = 0

    def on_batch_end(self, batch, logs=None):
        self._batches += 1
        if self._batches % self.commit_every == 0:
            self.state.commit()

    def on_epoch_end(self, epoch, logs=None):
        self.state.commit()


class GuardCallback(Callback):
    """Wire the step-integrity guard into a callback-driven loop: at
    train begin it attaches the rollback target (an
    :class:`~horovod_tpu_torch.elastic.State`) and the LR-backoff
    optimizer to the installed monitor; at batch end it runs the
    divergence probe at its cadence through ``get_params`` /
    ``set_params`` (the repaired parameters are written in place and
    handed to ``set_params``), and surfaces the last verdict as
    ``logs["guard_skipped"]``. It never calls ``end_step()``: the step's
    apply point does (the DistributedOptimizer, the compiled step or
    :func:`~horovod_tpu_torch.optimizers.guarded_apply_updates`). No-op
    without the guard. ``striped=True``: ZeRO-3's resident stripe,
    detection only; left None, the probe is striped when ``optimizer``
    is a ZeRO optimizer whose stripe is resident (a compiled zero3
    step), and then probes that stripe unless ``get_params`` is given."""

    def __init__(self, state=None, optimizer=None, get_params=None,
                 set_params=None, striped=None):
        self.state = state
        self.optimizer = optimizer
        self._get_params = get_params
        self._set_params = set_params
        self.striped = striped

    @staticmethod
    def _monitor():
        from . import guard
        return guard.get()

    def on_train_begin(self, logs=None):
        monitor = self._monitor()
        if monitor is None:
            return
        if self.state is not None:
            monitor.attach_state(self.state)
        if self.optimizer is not None:
            monitor.attach_optimizer(self.optimizer)

    def on_batch_end(self, batch, logs=None):
        monitor = self._monitor()
        if monitor is None:
            return
        resident = getattr(self.optimizer, "_resident", False)
        striped = resident if self.striped is None else self.striped
        get_params = self._get_params
        if get_params is None and resident:
            get_params = lambda: self.optimizer.stripe.detach()  # noqa: E731
        if get_params is not None:
            repaired = monitor.check_divergence(get_params(),
                                                striped=striped)
            if repaired is not None and self._set_params is not None:
                self._set_params(repaired)
        if logs is not None and monitor.last_verdict is not None:
            logs["guard_skipped"] = not monitor.last_verdict["ok"]


class LearningRateRescaleCallback(Callback):
    """Rescale the learning rate when the elastic world resizes: at
    train begin the anchor ``(lr, size())``; when ``size()`` changes, the
    target ``anchor_lr * resize_lr_factor(anchor_size, size, mode)``
    (``"linear"`` or ``"sqrt"``), reached linearly over ``ramp_steps``
    batches (0 = at once), with momentum correction as
    :class:`LearningRateScheduleCallback`."""

    def __init__(self, optimizer, mode="linear", ramp_steps=0,
                 momentum_correction=True):
        self.backend = _AttrBackend(optimizer)
        self.mode = mode
        self.ramp_steps = max(int(ramp_steps), 0)
        self.momentum_correction = momentum_correction
        self.anchor_lr = None
        self.anchor_size = None
        self._seen_size = None
        self._ramp = None  # (from_lr, to_lr, step, total)
        self.restore_momentum = None

    def on_train_begin(self, logs=None):
        from .optimizers import resize_lr_factor  # anchor validation
        resize_lr_factor(1, 1, self.mode)
        self.anchor_lr = self.backend.get("lr")
        self.anchor_size = size() if is_initialized() else 1
        self._seen_size = self.anchor_size

    def _set_lr(self, new_lr):
        old_lr = self.backend.get("lr")
        self.backend.set("lr", new_lr)
        if (self.backend.has("momentum") and self.momentum_correction
                and old_lr):
            self.restore_momentum = self.backend.get("momentum")
            self.backend.set("momentum",
                             self.restore_momentum * new_lr / old_lr)

    def on_batch_begin(self, batch, logs=None):
        if self.anchor_lr is None or not is_initialized():
            return
        from .optimizers import resize_lr_factor
        current = size()
        if current != self._seen_size:
            target = self.anchor_lr * resize_lr_factor(
                self.anchor_size, current, self.mode)
            self._seen_size = current
            if self.ramp_steps:
                self._ramp = (self.backend.get("lr"), target, 0,
                              self.ramp_steps)
            else:
                self._set_lr(target)
        if self._ramp is not None:
            frm, to, step, total = self._ramp
            step += 1
            self._set_lr(frm + (to - frm) * step / total)
            self._ramp = (frm, to, step, total) if step < total else None

    def on_batch_end(self, batch, logs=None):
        if self.restore_momentum:
            self.backend.set("momentum", self.restore_momentum)
            self.restore_momentum = None

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = self.backend.get("lr")


class LearningRateScheduleCallback(Callback):
    """lr = initial_lr * multiplier(epoch), with momentum correction
    (reference: _keras/callbacks.py:70-146)."""

    def __init__(self, optimizer, multiplier, start_epoch=0, end_epoch=None,
                 staircase=True, momentum_correction=True,
                 steps_per_epoch=None):
        self.backend = _AttrBackend(optimizer)
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.initial_lr = None
        self.restore_momentum = None
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = None
        if not callable(multiplier):
            self.staircase = True
            self.multiplier = lambda epoch: multiplier
        else:
            self.multiplier = multiplier

    def _autodetect_steps_per_epoch(self):
        if self.params and self.params.get("steps"):
            return self.params["steps"]
        if (self.params and self.params.get("samples")
                and self.params.get("batch_size")):
            return self.params["samples"] // self.params["batch_size"]
        raise ValueError(
            "Could not autodetect the number of steps per epoch. Please "
            "specify the steps_per_epoch parameter to the %s()."
            % self.__class__.__name__)

    def _adjust_learning_rate(self, epoch):
        old_lr = self.backend.get("lr")
        new_lr = self.initial_lr * self.multiplier(epoch)
        self.backend.set("lr", new_lr)
        if self.backend.has("momentum") and self.momentum_correction:
            # Momentum correction (Goyal et al.): scale m by new_lr/old_lr
            # while lr is in flux so effective update velocity is preserved.
            self.restore_momentum = self.backend.get("momentum")
            self.backend.set("momentum",
                             self.restore_momentum * new_lr / old_lr)

    def _restore_momentum_if_needed(self):
        if self.restore_momentum:
            self.backend.set("momentum", self.restore_momentum)
            self.restore_momentum = None

    def on_train_begin(self, logs=None):
        self.initial_lr = self.backend.get("lr")
        if not self.staircase and not self.steps_per_epoch:
            self.steps_per_epoch = self._autodetect_steps_per_epoch()

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch

    def on_batch_begin(self, batch, logs=None):
        if (self.current_epoch < self.start_epoch
                or (self.end_epoch is not None
                    and self.current_epoch >= self.end_epoch)):
            return
        if self.staircase and batch == 0:
            self._adjust_learning_rate(self.current_epoch)
        elif not self.staircase:
            epoch = self.current_epoch + float(batch) / self.steps_per_epoch
            self._adjust_learning_rate(epoch)

    def on_batch_end(self, batch, logs=None):
        self._restore_momentum_if_needed()

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = self.backend.get("lr")


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Linear warmup lr/size -> lr over warmup_epochs
    (reference: _keras/callbacks.py:149-168; Goyal et al. gradual warmup)."""

    def __init__(self, optimizer, warmup_epochs=5, momentum_correction=True,
                 steps_per_epoch=None, verbose=0):
        def multiplier(epoch):
            epoch += 1.0 / self.steps_per_epoch
            return 1.0 / size() * (epoch * (size() - 1) / warmup_epochs + 1)

        super().__init__(optimizer, multiplier, start_epoch=0,
                         end_epoch=warmup_epochs, staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch)
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose > 0:
            print("\nEpoch %d: finished gradual learning rate warmup to %g."
                  % (epoch + 1, self.backend.get("lr")))
