"""Step-integrity guard: numeric fault containment for distributed steps.

Counterpart of horovod_tpu/guard/. Three defenses:

1. **Gradient health on the reduced buffers.** Each reduced exchange
   buffer's segments get one ``[finite, l2]`` f32 row
   (ops/collectives.py ``segment_health``/``tree_health``): in the
   DistributedOptimizer's synchronize, in the eager engine's fused
   buckets, and inside the compiled step's captured graph. The reduced
   buffer is bit-identical on every rank, so each rank's verdict is too,
   without coordination; with several ranks every non-apply verdict is
   also recorded in the coordinator's decision log (the audit lane).
   The policy ladder: **skip** the bad step (parameters and optimizer
   state untouched), **back off the learning rate** after
   ``HOROVOD_GUARD_LR_BACKOFF_STEPS`` consecutive bad steps, **roll
   back** to the last :class:`~horovod_tpu_torch.elastic.State` commit
   after ``HOROVOD_GUARD_BAD_STEPS`` consecutive bad steps. The compiled
   step gates on the card and hands its rows over through pinned memory,
   read one step later (:meth:`GuardMonitor.consume_deferred`).

2. **Cross-replica divergence probe.** Every
   ``HOROVOD_GUARD_DIVERGENCE_INTERVAL`` steps a parameter digest
   (element count, float64 sum and sum of squares, computed on the
   parameters' device) is allgathered and compared bitwise; a mismatch
   is repaired by re-broadcasting the majority replica's parameters, or
   only detected in the striped (ZeRO-3) mode.

3. **Bounded collective retry.** With ``HOROVOD_GUARD_RETRY > 0`` the
   eager engine retries transient dispatch failures with exponential
   backoff under a deadline before escalating.

Everything is **inert by default**: ``HOROVOD_GUARD`` unset means no
monitor is installed and every hook is a ``None`` check; the optimizer
and the compiled step run their plain programs. The deterministic chaos
harness is :mod:`horovod_tpu_torch.guard.inject`.
"""

import threading

import numpy as np
import torch

from .. import metrics
from ..diag import recorder as diag
from ..utils.logging import get_logger
from . import inject

_logger = get_logger()


class GuardMonitor:
    """Per-process guard state machine: folds bucket-health verdicts into
    per-step decisions and runs the skip -> LR-backoff -> rollback policy
    ladder. One instance per session, installed by ``runtime.init()``
    before the engine (which caches it for its hot-path hooks)."""

    def __init__(self, config):
        self.config = config
        self.enabled = bool(getattr(config, "guard", False))
        self.bad_step_limit = max(
            int(getattr(config, "guard_bad_step_limit", 3)), 1)
        self.lr_backoff_steps = max(
            int(getattr(config, "guard_lr_backoff_steps", 2)), 1)
        self.lr_backoff_factor = float(
            getattr(config, "guard_lr_backoff_factor", 0.5))
        self.divergence_interval = int(
            getattr(config, "guard_divergence_interval", 0))
        self._lock = threading.Lock()
        self._bad = {}              # name -> reason, this step
        self._device_pending = []   # [(names, device health array)]
        self._consecutive = 0
        self._step = 0
        self._probe_step = 0
        self._state = None          # elastic.State for rollback
        self._lr_backend = None     # callbacks._AttrBackend for backoff
        self.decision_sink = None   # process 0: engine.publish_guard
        self.last_verdict = None
        self._recent = []           # last few verdicts, for reconciliation

    # -------------------------------------------------------- attachments

    def attach_state(self, state):
        """Give the ladder its rollback target (an elastic.State whose
        commits define 'last known good')."""
        self._state = state

    def attach_optimizer(self, optimizer):
        """Give the ladder an optimizer-like object exposing ``lr`` (or
        torch-style param_groups) for the backoff rung. A tensor ``lr``
        (``torch.optim.AdamW(lr=torch.tensor(...), capturable=True)``) is
        filled in place, which a captured step reads on its next replay;
        a float ``lr`` is replaced, which keys a new program signature
        (ops/step_program.py): both take effect, the tensor without a
        new capture."""
        from ..callbacks import _AttrBackend
        backend = _AttrBackend(optimizer)
        self._lr_backend = backend if backend.has("lr") else None

    # ------------------------------------------------- engine-facing hooks

    def note_bucket(self, name, finite, norm):
        """Host-path health verdict for one reduced bucket segment. The
        reduced buffer is bit-identical on all ranks, so this verdict is
        too — no coordination needed."""
        metrics.GUARD_CHECKED_BUCKETS.inc()
        if not finite or not np.isfinite(norm):
            with self._lock:
                self._bad[name] = "non-finite"

    def note_device_health(self, names, health, ready=None):
        """Stash a health tensor (one ``[finite, l2]`` row per segment,
        on the card or in pinned host memory) WITHOUT reading it: the
        read happens at end_step(). ``ready`` is a CUDA event recorded
        after the copy into pinned memory; end_step() waits on it
        alone."""
        metrics.GUARD_CHECKED_BUCKETS.inc(len(names))
        with self._lock:
            self._device_pending.append((tuple(names), health, ready))

    def _fold_device_locked(self):
        pending, self._device_pending = self._device_pending, []
        for names, health, ready in pending:
            if ready is not None:
                ready.synchronize()
            h = health.detach().cpu().numpy()
            for i, name in enumerate(names):
                finite = bool(h[i, 0] >= 0.5) and bool(np.isfinite(h[i, 1]))
                if not finite:
                    self._bad[name] = "non-finite"

    def consume_deferred(self, names, health, ready=None):
        """Deferred device-health fold for the compiled step program
        (ops/step_program.py): note the PREVIOUS compiled step's
        in-graph health matrix and run its policy ladder now. That
        program already gated the step's apply in-graph (params and
        optimizer state held when any segment went non-finite), so by
        the time this host-side fold reads the array the skip has
        happened; what end_step adds is the accounting plus the
        LR-backoff / rollback rungs — one step deferred, so the tiny
        readback never serializes the hot loop. Returns the verdict."""
        self.note_device_health(names, health, ready)
        return self.end_step()

    # ------------------------------------------------------- policy ladder

    def end_step(self):
        """Fold this step's bucket verdicts into one step verdict and run
        the policy ladder. Call exactly once per training step, after
        the step's gradient exchange has synchronized and before the
        optimizer update is applied; ``verdict["ok"]`` says whether to
        apply (optimizers.guarded_apply_updates does this for you)."""
        with self._lock:
            self._fold_device_locked()
            bad, self._bad = self._bad, {}
            self._step += 1
            verdict = {"step": self._step, "ok": not bad, "action": "apply",
                       "bad": sorted(bad)[:8]}
            if bad:
                self._consecutive += 1
                verdict["action"] = "skip"
                verdict["consecutive"] = self._consecutive
            else:
                self._consecutive = 0
            consecutive = self._consecutive
        if not verdict["ok"]:
            metrics.GUARD_BAD_STEPS.inc()
            metrics.GUARD_SKIPPED_STEPS.inc()
            _logger.warning(
                "guard: step %d skipped — non-finite reduced gradients in "
                "%s (%d consecutive bad)", verdict["step"], verdict["bad"],
                consecutive)
            if consecutive == self.lr_backoff_steps:
                self._apply_lr_backoff(verdict)
            if consecutive >= self.bad_step_limit:
                self._apply_rollback(verdict)
        self._record(verdict)
        return verdict

    def _apply_lr_backoff(self, verdict):
        if self._lr_backend is None:
            return
        old = float(self._lr_backend.get("lr"))
        new = old * self.lr_backoff_factor
        # a tensor lr is filled in place: a captured step reads it there
        self._lr_backend.set("lr", new)
        metrics.GUARD_LR_BACKOFFS.inc()
        verdict["lr_backoff"] = {"from": float(old), "to": float(new)}
        _logger.warning("guard: LR backoff %g -> %g after %d consecutive "
                        "bad steps", old, new, self.lr_backoff_steps)

    def _apply_rollback(self, verdict):
        verdict["action"] = "rollback"
        with self._lock:
            self._consecutive = 0
        if self._state is None:
            _logger.error(
                "guard: %d consecutive bad steps but no elastic.State "
                "attached — cannot roll back (attach one via "
                "GuardMonitor.attach_state / callbacks.GuardCallback)",
                self.bad_step_limit)
            return
        metrics.GUARD_ROLLBACKS.inc()
        _logger.error("guard: rolling back to last commit after %d "
                      "consecutive bad steps", self.bad_step_limit)
        diag.dump_post_mortem("guard_rollback", extra={"verdict": verdict},
                              force=True)
        self._state.restore()
        zero = getattr(self._state, "zero_residuals", None)
        if zero is not None:
            zero()
        verdict["rolled_back_to_commit"] = int(
            getattr(self._state, "_commits", 0))

    def _record(self, verdict):
        self.last_verdict = verdict
        fr = diag.get()
        if fr is not None:
            fr.record("guard_verdict", extra=dict(verdict))
        if verdict["action"] != "apply":
            self._recent = (self._recent + [verdict])[-16:]
            sink = self.decision_sink
            if sink is not None:
                try:
                    sink(verdict)
                except Exception:  # noqa: BLE001 — the record is advisory
                    _logger.debug("guard decision publish failed",
                                  exc_info=True)

    def apply_decision(self, decision):
        """A guard decision arrived through the coordinator's log (all
        processes see the same sequence at the same index). Verdicts are
        computed locally from bit-identical data, so this is the *audit*
        lane: record it, and scream if the local ladder ever disagreed —
        that would mean the bit-identical-buffer invariant broke."""
        fr = diag.get()
        if fr is not None:
            fr.record("guard_decision", extra=dict(decision))
        step = decision.get("step")
        for v in self._recent:
            if v["step"] == step and v["action"] != decision.get("action"):
                _logger.error(
                    "guard: DECISION MISMATCH at step %s — local %s vs "
                    "coordinator %s; reduced buffers are not bit-identical "
                    "across ranks", step, v["action"],
                    decision.get("action"))

    # -------------------------------------------------- divergence probe

    def check_divergence(self, params, striped=False):
        """Every ``divergence_interval`` calls: allgather a cheap digest
        of ``params`` and compare across ranks. Returns None when no
        probe ran or replicas agree; on mismatch, records the event,
        dumps a post-mortem and returns the REPAIRED params (the
        majority replica's, re-broadcast) for the caller to adopt.

        ``striped=True`` is the ZeRO-3 / stage-3 sharding-spec mode:
        ``params`` is this rank's resident STRIPE, so per-rank digests
        legitimately differ and the replicated-mode comparison would
        false-alarm on every probe. Instead the probe digests the local
        stripe, allgathers the per-rank digests into one matrix, then
        allgathers a digest OF that matrix — every rank must assemble
        the identical matrix, so a mismatch means the striped world
        lost consistency (e.g. a rank applied a step its peers
        skipped). No rank holds a full replica to repair from, so the
        event is detection-only (metric + post-mortem + None); recover
        via the elastic rollback rung (:meth:`attach_state`)."""
        if self.divergence_interval <= 0:
            return None
        self._probe_step += 1
        if self._probe_step % self.divergence_interval:
            return None
        import horovod_tpu_torch as hvd
        digest = parameter_digest(params)
        gathered = hvd.allgather(
            torch.from_numpy(digest).to(hvd.runtime.device()),
            name="guard.divergence.digest").cpu().numpy().reshape(
                -1, digest.size)
        if striped:
            return self._check_striped_divergence(gathered)
        groups = {}
        for r, row in enumerate(gathered):
            groups.setdefault(row.tobytes(), []).append(r)
        if len(groups) <= 1:
            return None
        majority = max(groups.values(), key=lambda ranks: (len(ranks),
                                                           -min(ranks)))
        root = min(majority)
        metrics.GUARD_DIVERGENCE.inc()
        _logger.error(
            "guard: replica divergence detected — %d distinct parameter "
            "digests across %d ranks (majority group %s); repairing by "
            "broadcast from rank %d", len(groups), gathered.shape[0],
            majority, root)
        diag.dump_post_mortem(
            "divergence", force=True,
            extra={"digests": {str(min(rs)): list(map(int, rs))
                               for rs in groups.values()},
                   "repair_root": int(root)})
        _broadcast_in_place(params, root)
        metrics.GUARD_REPAIRS.inc()
        return params

    def _check_striped_divergence(self, gathered):
        """Phase 2 of the striped probe: every rank digests the
        assembled stripe-digest matrix and allgathers THAT — agreement
        means every rank saw the same global stripe state this probe."""
        import horovod_tpu_torch as hvd
        mdigest = parameter_digest(torch.from_numpy(gathered))
        rows = hvd.allgather(
            torch.from_numpy(mdigest).to(hvd.runtime.device()),
            name="guard.divergence.stripes").cpu().numpy().reshape(
                -1, mdigest.size)
        groups = {}
        for r, row in enumerate(rows):
            groups.setdefault(row.tobytes(), []).append(r)
        if len(groups) <= 1:
            return None
        metrics.GUARD_DIVERGENCE.inc()
        _logger.error(
            "guard: striped-layout divergence — %d distinct stripe-digest "
            "matrices across %d ranks (groups %s); no rank holds a full "
            "replica, so no broadcast repair is possible: roll back to the "
            "last elastic commit (GuardMonitor.attach_state / "
            "hvd.elastic.State.restore)", len(groups), rows.shape[0],
            sorted(map(min, groups.values())))
        diag.dump_post_mortem(
            "divergence_striped", force=True,
            extra={"matrix_digests": {str(min(rs)): list(map(int, rs))
                                      for rs in groups.values()}})
        return None


def _tensors(params):
    """The tensors of a parameter collection: a module, a state_dict,
    a tensor, or a (nested) list/tuple/dict of them, in a fixed order."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if torch.is_tensor(params):
        return [params]
    if isinstance(params, dict):
        return [t for k in sorted(params, key=str)
                for t in _tensors(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in _tensors(p)]
    return []


def _broadcast_in_place(params, root):
    """Overwrite every tensor of ``params`` with ``root``'s."""
    from ..ops.collectives import broadcast_
    with torch.no_grad():
        for t in _tensors(params):
            broadcast_(t, root)


def parameter_digest(params):
    """Cheap, deterministic digest of a parameter collection (a module,
    a state_dict, a tensor or nested lists of them): ``[element count,
    float64 sum, float64 sum of squares]`` as a numpy array. Each sum
    runs on the tensors' own device, so replicas with identical bits
    give identical digests; drifted replicas differ in the sums."""
    total = 0
    s = ss = None
    for t in _tensors(params):
        x = t.detach().to(torch.float64)
        total += x.numel()
        ts, tss = x.sum(), (x * x).sum()
        s = ts if s is None else s + ts
        ss = tss if ss is None else ss + tss
    if s is None:
        return np.asarray([0.0, 0.0, 0.0], dtype=np.float64)
    return np.asarray([float(total), float(s), float(ss)],
                      dtype=np.float64)


# ------------------------------------------------ process-wide installation

_monitor = None


def install(config, process_index=0):
    """Create (or replace) the process guard monitor and chaos injector
    from config. Returns the monitor, or None when ``HOROVOD_GUARD`` is
    off (the injector installs independently — chaos can target an
    unguarded build to prove the faults really do poison it)."""
    global _monitor
    inject.install(config, process_index=process_index)
    if not getattr(config, "guard", False):
        _monitor = None
        return None
    _monitor = GuardMonitor(config)
    return _monitor


def get():
    """The process guard monitor, or None when disabled."""
    return _monitor


def uninstall():
    global _monitor
    _monitor = None
    inject.uninstall()
