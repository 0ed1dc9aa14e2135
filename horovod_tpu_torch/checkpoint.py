"""horovod_tpu_torch.checkpoint: checkpoint/resume with content digests.

Counterpart of horovod_tpu/checkpoint.py, which writes through orbax.
The port writes its own step directory: each process ``torch.save``s
its flattened state (``state-<rank>.pt``: the pytree's leaves on the
host and its ``treespec``), to a temporary file renamed into place.

- ``save(path, state)`` / ``restore(path, like=None)``: one-shot pytree
  save and restore. With ``like`` the leaves come back on ``like``'s
  devices and dtypes, in its structure; without it, as saved (host
  tensors and Python scalars).
- ``CheckpointManager(directory, max_to_keep=...)``: step-versioned
  checkpoints (``<directory>/<step>/``), written under ``<step>.tmp``
  and renamed once every process wrote, with retention, latest-step
  lookup and the JAX package's sidecar digest: sha256 over the step
  directory's files in sorted relpath order (relpaths mixed in),
  ``<step>.digest.json``, written by process 0 and verified at restore.
  A step that fails its digest is skipped by ``latest_valid_step`` and
  refused by an explicit ``restore(step)`` with
  :class:`~horovod_tpu_torch.exceptions.CheckpointCorruptError`.

With several processes, ``save`` and ``CheckpointManager.save`` are
collective: every process calls them (a barrier through the eager
engine orders the writes before the rename and the digest).
"""

import hashlib
import json
import os
import shutil

import torch
from torch.utils import _pytree as pytree

from .exceptions import CheckpointCorruptError
from .utils.logging import get_logger

_logger = get_logger()


def _rank_size():
    from . import runtime
    if runtime.is_initialized():
        return runtime.rank(), runtime.size()
    return 0, 1


def _barrier(tag):
    """Every process of the job reaches this point (a tiny engine
    all-reduce); a no-op for one process."""
    from . import runtime
    if not runtime.is_initialized() or runtime.size() == 1:
        return
    import horovod_tpu_torch as hvd
    hvd.allreduce(torch.zeros(1, device=runtime.device()),
                  name=f"ckpt.barrier.{tag}")


def _host(leaf):
    """A leaf as it is written: tensors on the host (a host tensor as it
    is: ``torch.save`` copies its bytes)."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
        return leaf if leaf.device.type == "cpu" else leaf.cpu()
    return leaf


def _write_file(path, state):
    leaves, spec = pytree.tree_flatten(state)
    payload = {"format": 1, "treespec": pytree.treespec_dumps(spec),
               "leaves": [_host(x) for x in leaves]}
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _read_file(path):
    payload = torch.load(path, map_location="cpu", weights_only=False)
    spec = pytree.treespec_loads(payload["treespec"])
    return payload["leaves"], spec


def _state_file(root, rank):
    return os.path.join(root, f"state-{rank}.pt")


def _restore_dir(root, like):
    rank, _ = _rank_size()
    path = _state_file(root, rank)
    if not os.path.exists(path):
        path = _state_file(root, 0)  # a replicated state: rank 0's file
    leaves, spec = _read_file(path)
    if like is None:
        return pytree.tree_unflatten(leaves, spec)
    like_leaves, like_spec = pytree.tree_flatten(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint at {root} holds {len(leaves)} leaves, like= has "
            f"{len(like_leaves)}")
    out = []
    for got, want in zip(leaves, like_leaves):
        if torch.is_tensor(want):
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint leaf of shape {tuple(got.shape)} where "
                    f"like= has {tuple(want.shape)}")
            got = got.to(device=want.device, dtype=want.dtype)
        out.append(got)
    return pytree.tree_unflatten(out, like_spec)


def save(path, state, force=False):
    """Write ``state`` (a pytree of tensors and scalars) at ``path``, one
    file per process. ``force=True`` overwrites an existing checkpoint
    there (default raises)."""
    path = os.path.abspath(path)
    rank, _ = _rank_size()
    if os.path.exists(_state_file(path, rank)) and not force:
        raise FileExistsError(f"a checkpoint exists at {path} "
                              f"(pass force=True to overwrite it)")
    os.makedirs(path, exist_ok=True)
    _write_file(_state_file(path, rank), state)
    _barrier(os.path.basename(path))


def restore(path, like=None):
    """Read the pytree at ``path``: with ``like``, its leaves on
    ``like``'s devices and dtypes, in its structure; else as saved."""
    return _restore_dir(os.path.abspath(path), like)


class CheckpointManager:
    """Step-versioned checkpoints with retention and content digests.

    >>> mgr = CheckpointManager("/ckpts", max_to_keep=3)
    >>> mgr.save(step, {"params": params, "opt": opt_state})
    >>> state = mgr.restore(like={"params": params, "opt": opt_state})
    """

    def __init__(self, directory, max_to_keep=5, save_interval_steps=1):
        self._directory = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._interval = max(int(save_interval_steps), 1)
        os.makedirs(self._directory, exist_ok=True)

    @property
    def directory(self):
        return self._directory

    def save(self, step, state, force=False):
        """Returns True if a checkpoint was written (``save_interval_
        steps`` applies unless ``force``). The step is written under
        ``<step>.tmp``, renamed once every process wrote, digested by
        process 0 into its sidecar, and old steps beyond
        ``max_to_keep`` are pruned."""
        step = int(step)
        if not force and step % self._interval:
            return False
        final = os.path.join(self._directory, str(step))
        if os.path.exists(final) and not force:
            return False
        rank, _ = _rank_size()
        tmp = f"{final}.tmp"
        os.makedirs(tmp, exist_ok=True)
        _write_file(_state_file(tmp, rank), state)
        _barrier(f"{step}.written")
        if rank == 0:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._write_sidecar(step)
            self._prune()
        _barrier(f"{step}.committed")
        return True

    # ------------------------------------------------ content integrity

    def _sidecar_path(self, step):
        return os.path.join(self._directory, f"{int(step)}.digest.json")

    def _step_digest(self, step):
        """sha256 over the step directory's files in sorted relpath order
        (relpath mixed into the hash, so a renamed/moved file fails too).
        Returns (hexdigest, nfiles) or (None, 0) when the dir is gone."""
        root = os.path.join(self._directory, str(int(step)))
        if not os.path.isdir(root):
            return None, 0
        h = hashlib.sha256()
        nfiles = 0
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for fn in sorted(filenames):
                path = os.path.join(dirpath, fn)
                h.update(os.path.relpath(path, root).encode())
                with open(path, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
                nfiles += 1
        return h.hexdigest(), nfiles

    def _write_sidecar(self, step):
        digest, nfiles = self._step_digest(step)
        if digest is None:
            return
        tmp = f"{self._sidecar_path(step)}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "sha256": digest,
                       "files": nfiles}, f)
        os.replace(tmp, self._sidecar_path(step))

    def verify_step(self, step):
        """True when ``step``'s bytes on disk match its sidecar digest. A
        step with no sidecar is accepted (integrity checking is opt-out
        by absence, never a migration barrier)."""
        sidecar = self._sidecar_path(step)
        if not os.path.exists(sidecar):
            return True
        try:
            with open(sidecar) as f:
                expected = json.load(f).get("sha256")
        except Exception:  # noqa: BLE001 — unreadable sidecar = unverified
            expected = None
        if expected is None:
            return True
        digest, _ = self._step_digest(step)
        if digest == expected:
            return True
        from . import metrics
        metrics.CHECKPOINT_INTEGRITY_FAILURES.inc()
        _logger.warning(
            "checkpoint step %s failed its sidecar content digest "
            "(expected %s, got %s)", step, expected, digest)
        return False

    def latest_valid_step(self):
        """Newest step whose content digest verifies (or that has no
        sidecar to verify against): corruption costs one checkpoint of
        progress, not the job."""
        for step in reversed(self.all_steps()):
            if self.verify_step(step):
                return step
        return None

    def restore(self, step=None, like=None):
        """Restore ``step`` (default: the newest VALID step). An explicit
        step that fails its digest raises CheckpointCorruptError; the
        latest-step mode falls back to the next-newest valid step."""
        if step is None:
            step = self.latest_valid_step()
            if step is None:
                raise FileNotFoundError("no checkpoint steps found")
            newest = self.latest_step()
            if newest is not None and step != newest:
                _logger.warning(
                    "checkpoint restore falling back to step %s: newer "
                    "step(s) up to %s failed integrity verification",
                    step, newest)
        elif not self.verify_step(step):
            raise CheckpointCorruptError(
                f"checkpoint step {step} failed its sidecar content "
                f"digest; refusing the explicit restore (latest-mode "
                f"restore falls back to the newest valid step instead)")
        return _restore_dir(os.path.join(self._directory, str(int(step))),
                            like)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        return sorted(int(n) for n in os.listdir(self._directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self._directory, n)))

    def _prune(self):
        if not self._max_to_keep:
            return
        for step in self.all_steps()[:-self._max_to_keep]:
            shutil.rmtree(os.path.join(self._directory, str(step)),
                          ignore_errors=True)
            try:
                os.unlink(self._sidecar_path(step))
            except OSError:
                pass

    def wait_until_finished(self):
        """Saves are synchronous: nothing to wait for."""

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def save_for_rank0_broadcast(path, state, rank, barrier=True):
    """The reference discipline as one call: rank 0 writes host copies,
    every restart restores and broadcasts (reference pattern:
    ``if hvd.rank() == 0: save(...)`` then ``broadcast_parameters``).
    Returns True when this rank wrote. With ``barrier=True`` every rank
    joins a tiny engine all-reduce after the write, so no rank races
    ahead into a restore of a half-written checkpoint."""
    wrote = False
    path = os.path.abspath(path)
    if rank == 0:
        os.makedirs(path, exist_ok=True)
        _write_file(_state_file(path, 0), state)
        wrote = True
    if barrier:
        _barrier(os.path.basename(path))
    return wrote
