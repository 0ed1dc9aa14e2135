"""Elastic training state: in-memory commit/rollback plus periodic
durable commits through :class:`horovod_tpu_torch.checkpoint.CheckpointManager`.

Counterpart of horovod_tpu/elastic/state.py (upstream analog: Elastic
Horovod's ``TorchState``). Fields are declared as constructor kwargs:
tensors, ``nn.Module``s (their ``state_dict`` tensors),
``torch.optim.Optimizer``s (each parameter's state: AdamW's step count
and moments; a ZeRO optimizer's stripe and DCN residual too; the param
groups' hyperparameters are not part of a commit, so a guard's
learning-rate back-off survives a rollback), nested
dicts/lists/tuples of them, and Python scalars.

- ``commit()`` snapshots every tensor to host memory, as the reference
  snapshots its leaves to numpy: pinned buffers for card tensors, copied
  with ``non_blocking=True`` and one synchronisation at the end. Two
  buffer sets alternate, so the last complete commit stays intact while
  the next one is written.
- ``restore()`` writes the snapshot back **into the existing tensors**
  with ``copy_``: a captured CUDA graph (ops/step_program.py) keeps
  reading the same storage, so a rollback needs no new capture.
- ``sync(root_rank)`` broadcasts every tensor in place from the root and
  the scalars with ``broadcast_object_list``.

Usage::

    state = elastic.State(model=model, optimizer=opt, step=0,
                          manager=CheckpointManager("/ckpts"),
                          durable_interval=50)
    state.commit()                 # after N good steps
    ...
    state.restore()                # after WorkerLostError: last commit
    state.sync(root_rank=0)        # after re-rendezvous: all agree
"""

import glob
import hashlib
import io
import os

import torch

from ..utils.logging import get_logger

_logger = get_logger()

_SCALARS = (int, float, bool, str, bytes, type(None))


def _optimizer_params(opt):
    return [p for g in opt.param_groups for p in g["params"]]


def _host_like(t, prev):
    """A host buffer for ``t``: ``prev`` when it fits, else a new one
    (pinned for a card tensor)."""
    if (torch.is_tensor(prev) and prev.shape == t.shape
            and prev.dtype == t.dtype):
        return prev
    return torch.empty(t.shape, dtype=t.dtype, device="cpu",
                       pin_memory=t.is_cuda)


def _snap(value, prev):
    """The host snapshot of one field, reusing ``prev``'s buffers."""
    if torch.is_tensor(value):
        buf = _host_like(value, prev)
        buf.copy_(value.detach(), non_blocking=value.is_cuda)
        return buf
    if isinstance(value, torch.nn.Module):
        prev = prev if isinstance(prev, dict) else {}
        return {k: _snap(v, prev.get(k))
                for k, v in value.state_dict().items()}
    if isinstance(value, torch.optim.Optimizer):
        extra = _extra_of(value)
        if extra is not None:
            prev = prev if isinstance(prev, dict) else {}
            return {"state": _snap_state(value, prev.get("state")),
                    "extra": {k: _snap(v, prev.get("extra", {}).get(k))
                              for k, v in extra.items()}}
        return _snap_state(value, prev)
    if isinstance(value, dict):
        prev = prev if isinstance(prev, dict) else {}
        return {k: _snap(v, prev.get(k)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        prev = prev if isinstance(prev, (list, tuple)) else ()
        out = [_snap(v, prev[i] if i < len(prev) else None)
               for i, v in enumerate(value)]
        return type(value)(out) if isinstance(value, tuple) else out
    if isinstance(value, _SCALARS):
        return value
    raise TypeError(f"elastic.State cannot snapshot a {type(value)!r}")


def _extra_of(opt):
    """A ZeRO optimizer's tensors beyond its state (the stripe, the DCN
    residual: ``_ShardedOptimizer.elastic_tensors``), or None."""
    fn = getattr(opt, "elastic_tensors", None)
    return fn() if fn is not None else None


def _snap_state(opt, prev):
    """Each parameter's optimizer state, in parameter order."""
    prev = prev if isinstance(prev, list) else []
    out = []
    for i, p in enumerate(_optimizer_params(opt)):
        old = prev[i] if i < len(prev) else None
        st = opt.state.get(p, {})
        out.append(None if not st else
                   {k: _snap(v, old.get(k) if old else None)
                    for k, v in st.items()})
    return out


def _put(live, snap):
    """``snap`` written back into ``live`` (in place where ``live`` is a
    tensor of the same shape and dtype); returns the field's new value."""
    if torch.is_tensor(live) and torch.is_tensor(snap):
        if live.shape == snap.shape and live.dtype == snap.dtype:
            with torch.no_grad():
                live.copy_(snap, non_blocking=live.is_cuda)
            return live
        return snap.to(live.device, copy=True)
    if isinstance(live, torch.nn.Module):
        sd = live.state_dict()
        with torch.no_grad():
            for k, v in snap.items():
                sd[k].copy_(v, non_blocking=sd[k].is_cuda)
        return live
    if isinstance(live, torch.optim.Optimizer):
        if hasattr(live, "reset_exchange"):
            live.reset_exchange()  # a DistributedOptimizer's cut exchange
        if isinstance(snap, dict):
            # a ZeRO optimizer: the stripe and the residual, in place
            extra = _extra_of(live) or {}
            for k, v in snap["extra"].items():
                _put(extra[k], v)
            snap = snap["state"]
        for p, st in zip(_optimizer_params(live), snap):
            if st is None:
                live.state.pop(p, None)
                continue
            cur = live.state.setdefault(p, {})
            for k, v in st.items():
                if torch.is_tensor(v):
                    if k in cur and torch.is_tensor(cur[k]):
                        cur[k] = _put(cur[k], v)
                    else:
                        # a state tensor lives beside its parameter;
                        # a step count too where the optimizer is
                        # capturable, else on the host
                        on_param = v.dim() > 0 or _capturable(live)
                        cur[k] = v.to(p.device if on_param else "cpu",
                                      copy=True)
                else:
                    cur[k] = v
        return live
    if isinstance(live, dict) and isinstance(snap, dict):
        for k, v in snap.items():
            live[k] = _put(live.get(k), v)
        return live
    if isinstance(snap, (list, tuple)):
        if isinstance(live, list) and len(live) == len(snap):
            for i, v in enumerate(snap):
                live[i] = _put(live[i], v)
            return live
        vals = [_put(live[i] if isinstance(live, (list, tuple))
                     and i < len(live) else None, v)
                for i, v in enumerate(snap)]
        return type(snap)(vals) if isinstance(snap, tuple) else vals
    if torch.is_tensor(snap):
        return snap.clone()
    return snap


def _capturable(opt):
    return any(g.get("capturable") for g in opt.param_groups)


def _tensors_of(value):
    """Every tensor of a field in a fixed order (for sync)."""
    if torch.is_tensor(value):
        return [value]
    if isinstance(value, torch.nn.Module):
        return list(value.state_dict().values())
    if isinstance(value, torch.optim.Optimizer):
        # a ZeRO optimizer's state over its stripe is this rank's own:
        # only its step counts are everyone's
        own = getattr(value, "_hvd_sharded_state", False)
        return [v for p in _optimizer_params(value)
                for _, v in sorted(value.state.get(p, {}).items())
                if torch.is_tensor(v) and not (own and v.dim() > 0)]
    if isinstance(value, dict):
        return [t for k in sorted(value, key=str)
                for t in _tensors_of(value[k])]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors_of(v)]
    return []


class State:
    """A named collection of training state with commit/rollback::

        state = State(model=model, optimizer=opt, step=0)
        state.step += 1
        state.commit()
    """

    def __init__(self, manager=None, durable_interval=0, **fields):
        object.__setattr__(self, "_fields", dict(fields))
        object.__setattr__(self, "_committed", None)
        object.__setattr__(self, "_spare", None)
        object.__setattr__(self, "_manager", manager)
        object.__setattr__(self, "_durable_interval", int(durable_interval))
        object.__setattr__(self, "_durable_suspended", None)
        object.__setattr__(self, "_commits", 0)
        object.__setattr__(self, "_reset_callbacks", [])
        object.__setattr__(self, "_commit_hooks", [])
        object.__setattr__(self, "_post_commit_hooks", [])
        from ..config import Config
        object.__setattr__(self, "_grace_dir",
                           Config.from_env().elastic_grace_dir)

    def __getattr__(self, name):
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return fields[name]
        raise AttributeError(f"elastic.State has no field {name!r}")

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._fields[name] = value

    @property
    def fields(self):
        """The live field dict (a shallow copy; mutate via attributes)."""
        return dict(self._fields)

    @property
    def commits(self):
        return self._commits

    @property
    def committed(self):
        """The last commit's host snapshot (None before the first)."""
        return self._committed

    def register_reset_callback(self, fn):
        """Run ``fn()`` after every restore: re-derive what hangs off the
        state (a data-loader position) that a rollback invalidates."""
        self._reset_callbacks.append(fn)

    def register_commit_hook(self, fn):
        """Run ``fn()`` at the top of every ``commit()``, BEFORE the
        snapshot (a data-loader position via
        ``hvd.data.attach_to_state``)."""
        self._commit_hooks.append(fn)

    def register_post_commit_hook(self, fn):
        """Run ``fn()`` at the end of every ``commit()``, AFTER the
        snapshot landed: the preemption grace departs here."""
        self._post_commit_hooks.append(fn)

    def _snapshot(self, prev):
        snap = {k: _snap(v, prev.get(k) if prev else None)
                for k, v in self._fields.items()}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the non-blocking copies landed
        return snap

    def commit(self, step=None):
        """Snapshot the current fields to host memory as the rollback
        point. Commit hooks run first. Every ``durable_interval``-th
        commit also writes a versioned checkpoint through the manager.
        Returns the commit index."""
        for fn in self._commit_hooks:
            fn()
        snap = self._snapshot(self._spare)
        self._spare, self._committed = self._committed, snap
        self._commits += 1
        if (self._manager is not None and self._durable_interval > 0
                and self._durable_suspended is None
                and self._commits % self._durable_interval == 0):
            durable_step = int(step) if step is not None else self._commits
            self._manager.save(durable_step, snap, force=True)
        for fn in self._post_commit_hooks:
            fn()
        return self._commits

    def save_grace(self, path=None):
        """Durably snapshot the last commit (the live fields if nothing
        was ever committed) as a single-process grace file: the
        preemption exit ramp. Atomic (tmp + rename), with a sha256 over
        the serialized payload that ``restore`` verifies. Returns the
        path, or None when no grace dir is configured."""
        if path is None:
            if not self._grace_dir:
                return None
            from .. import runtime
            rank = runtime.world_rank() if runtime.is_initialized() else 0
            path = os.path.join(self._grace_dir, f"grace-{rank}.pt")
        snap = self._committed
        if snap is None:
            snap = self._snapshot(None)
        buf = io.BytesIO()
        torch.save({"fields": snap, "commits": self._commits}, buf)
        blob = buf.getvalue()
        wrapped = {"blob": blob, "sha256": hashlib.sha256(blob).hexdigest()}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(wrapped, tmp)
        os.replace(tmp, path)
        return path

    @staticmethod
    def _latest_grace(grace_dir):
        """Newest grace file in ``grace_dir`` by commit count (mtime
        tiebreak); a file whose digest fails is skipped."""
        best = None
        for path in glob.glob(os.path.join(grace_dir, "grace-*.pt")):
            try:
                wrapped = torch.load(path, map_location="cpu",
                                     weights_only=False)
                blob = wrapped["blob"]
                if hashlib.sha256(blob).hexdigest() != wrapped.get("sha256"):
                    from .. import metrics
                    metrics.CHECKPOINT_INTEGRITY_FAILURES.inc()
                    _logger.warning(
                        "elastic: grace file %s failed its content "
                        "digest; skipping it", path)
                    continue
                payload = torch.load(io.BytesIO(blob), map_location="cpu",
                                     weights_only=False)
                stamp = (int(payload.get("commits", 0)),
                         os.path.getmtime(path))
            except Exception:  # noqa: BLE001 — a torn write loses one file
                continue
            if best is None or stamp > best[0]:
                best = (stamp, payload)
        return None if best is None else best[1]

    def suspend_durable(self, reason):
        """Stop writing durable commits (in-memory commits continue):
        after a lossy recovery a collective save over the shrunk job
        would no longer match the original gang's checkpoints."""
        if self._durable_suspended is None and self._manager is not None:
            _logger.warning(
                "elastic: durable commits suspended (%s); in-memory "
                "commits continue, and the last written checkpoint "
                "remains the gang-restart anchor", reason)
        self._durable_suspended = reason

    def _apply(self, snap):
        for k, v in snap.items():
            self._fields[k] = _put(self._fields.get(k), v)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the pinned sources may be reused

    def restore(self):
        """Roll back to the last commit, in place. A fresh process (no
        in-memory commit) restores the newest grace snapshot if a
        draining gang left one, else the newest valid durable
        checkpoint; with neither, the initial fields stand. A ZeRO
        optimizer's stripe, state and DCN residual come back with the
        commit. Reset callbacks run afterwards."""
        grace = None
        if self._committed is None and self._grace_dir:
            grace = self._latest_grace(self._grace_dir)
        if self._committed is not None:
            self._apply(self._committed)
        elif grace is not None:
            self._apply(grace["fields"])
            self._commits = max(self._commits, int(grace["commits"]))
        elif self._manager is not None:
            latest = self._manager.latest_valid_step()
            if latest is not None:
                self._apply(self._manager.restore(latest))
                self._commits = max(self._commits, int(latest))
        for fn in self._reset_callbacks:
            fn()

    def zero_residuals(self):
        """Zero the DCN error-feedback residual of every ZeRO optimizer
        field, after a rollback the guard or the divergence probe
        ordered: the compression error of the abandoned steps must not
        feed the next exchange (the JAX package's chaos run zeroes the
        restored ``ZeroShardState.residual`` likewise)."""
        for v in self._fields.values():
            if hasattr(v, "zero_residual"):
                v.zero_residual()

    def sync(self, root_rank=0):
        """Broadcast the fields from ``root_rank`` (tensors in place, the
        rest as objects) so every (possibly just-restored) worker
        continues from identical state."""
        from .. import runtime
        if not runtime.is_initialized() or runtime.size() == 1:
            return
        import torch.distributed as dist

        from ..ops.collectives import broadcast_, peer_errors
        names = sorted(self._fields)
        with torch.no_grad():
            for name in names:
                for t in _tensors_of(self._fields[name]):
                    broadcast_(t, root_rank)
        plain = {k: v for k, v in self._fields.items()
                 if isinstance(v, _SCALARS)}
        box = [plain]
        with peer_errors():
            dist.broadcast_object_list(box, src=root_rank)
        self._fields.update(box[0])
