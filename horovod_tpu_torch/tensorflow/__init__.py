"""horovod_tpu_torch.tensorflow: the TensorFlow binding.

Counterpart of horovod_tpu/tensorflow/ (upstream: horovod/tensorflow/
__init__.py, tensorflow/mpi_ops.py): ``allreduce`` with a dense average
and the IndexedSlices path (two allgathers), ``allgather`` and
``broadcast`` with their registered gradients,
``broadcast_global_variables`` / ``broadcast_variables``,
``BroadcastGlobalVariablesHook``, ``DistributedOptimizer`` and
``DistributedGradientTape``, with ``Compression``.

TensorFlow is a front end on the host: its values cross to the port's
eager engine as numpy and are held there as CPU torch tensors, so the
engine negotiates, fuses and reduces them as any other submission (over
gloo on the CPU; a card session's engine moves them through the card
and hands the result back on the CPU). Inside ``tf.function`` the hop
is a ``tf.py_function``, as in the JAX package. TensorFlow is imported
by this module only: ``import horovod_tpu_torch`` does not import it,
and the machine with the card has none.
"""

import numpy as np
import tensorflow as tf
import torch

from .. import allgather as _hvd_allgather
from .. import allreduce as _hvd_allreduce
from .. import broadcast as _hvd_broadcast
from .. import runtime as _rt
from ..exceptions import (DuplicateNameError, HorovodError,  # noqa: F401
                          MismatchError, NotInitializedError, ShutDownError)


def _host(value):
    """A numpy value as a CPU torch tensor (a copy: a 0-d array stays
    0-d)."""
    return torch.from_numpy(np.array(value))


def _allreduce(value, average=True, name=None):
    return _hvd_allreduce(_host(value), average=average,
                          name=name).detach().cpu().numpy()


def _allgather(value, name=None):
    return _hvd_allgather(_host(value), name=name).detach().cpu().numpy()


def _broadcast(value, root_rank, name=None):
    return _hvd_broadcast(_host(value), root_rank,
                          name=name).detach().cpu().numpy()


init = _rt.init
shutdown = _rt.shutdown
size = _rt.size
local_size = _rt.local_size
rank = _rt.rank
local_rank = _rt.local_rank
mpi_threads_supported = _rt.mpi_threads_supported


class Compression:
    """(upstream: tensorflow/compression.py)"""

    class none:
        @staticmethod
        def compress(tensor):
            return tensor, None

        @staticmethod
        def decompress(tensor, ctx):
            return tensor

    class fp16:
        @staticmethod
        def compress(tensor):
            ctx = tensor.dtype
            if tensor.dtype.is_floating:
                tensor = tf.cast(tensor, tf.float16)
            return tensor, ctx

        @staticmethod
        def decompress(tensor, ctx):
            if ctx is not None and ctx.is_floating:
                tensor = tf.cast(tensor, ctx)
            return tensor


def allreduce(tensor, average=True, device_dense="", device_sparse="",
              compression=Compression.none, name=None):
    """Average (default) or sum across ranks.

    Sparse path parity: a tf.IndexedSlices is reduced as a gather of values
    and indices divided by size — upstream's two-allgather construction
    (tensorflow/__init__.py:36-82). device_dense/device_sparse are accepted
    for signature parity; the engine places the exchange.
    """
    del device_dense, device_sparse
    if isinstance(tensor, tf.IndexedSlices):
        values = tf.convert_to_tensor(tensor.values)
        indices = tf.convert_to_tensor(tensor.indices)
        new_values = _allgather(values.numpy(),
                                name=None if name is None
                                else f"{name}.values")
        new_indices = _allgather(indices.numpy(),
                                 name=None if name is None
                                 else f"{name}.indices")
        new_values = tf.convert_to_tensor(new_values)
        if average:
            new_values = new_values / size()
        return tf.IndexedSlices(tf.cast(new_values, values.dtype),
                                tf.convert_to_tensor(new_indices),
                                dense_shape=tensor.dense_shape)
    t = tf.convert_to_tensor(tensor)

    @tf.custom_gradient
    def _apply(x):
        compressed, ctx = compression.compress(x)

        def wire(z):
            out = tf.convert_to_tensor(
                _allreduce(z.numpy(), average, name))
            if out.dtype != z.dtype:
                out = tf.cast(out, z.dtype)
            return out

        if hasattr(compressed, "numpy"):
            out = wire(compressed)
        else:
            # Inside tf.function / keras fit: hop to the host engine through
            # py_function (upstream reaches its C++ core through a custom
            # TF op kernel, tensorflow/mpi_ops.cc:276: the same boundary,
            # no custom op). py_function nodes do not serialize into a
            # SavedModel and run on the host; training under tf.function
            # works (test_tf_function_training).
            out = tf.py_function(wire, [compressed], Tout=compressed.dtype)
            out.set_shape(compressed.shape)
        out = compression.decompress(out, ctx)

        def grad(dy):
            # Gradient of an allreduce is the allreduce of the gradient
            # with the same averaging (upstream: the registered gradient
            # for HorovodAllreduce, tensorflow/mpi_ops.py:92-109 — grad of
            # the sum op is _allreduce(dy); the /size of averaging then
            # flows through the division).
            return allreduce(dy, average=average, compression=compression,
                             name=None if name is None else f"{name}.grad")

        return out, grad

    return _apply(t)


def allgather(tensor, name=None):
    """Allgather with upstream's registered gradient: backward sums
    every rank's gradient and takes this rank's dim-0 slice
    (upstream: tensorflow/mpi_ops.py _allgather_grad)."""
    t = tf.convert_to_tensor(tensor)

    @tf.custom_gradient
    def _ag(x):
        out = tf.convert_to_tensor(_allgather(x.numpy(), name=name))
        dim = int(x.shape[0])

        def grad(dy):
            # densify: tf.gather-style consumers hand back IndexedSlices,
            # which the dim-0 slice below cannot subscript
            dy = tf.convert_to_tensor(dy)
            grad_reduced = allreduce(
                dy, average=False,
                name=None if name is None else f"{name}.grad")
            sizes = tf.convert_to_tensor(_allgather(
                np.array([dim], np.int32),
                name=None if name is None else f"{name}.grad.sizes"))
            r = rank()
            offset = int(tf.reduce_sum(sizes[:r])) if r != 0 else 0
            return grad_reduced[offset:offset + dim]

        return out, grad

    return _ag(t)


def broadcast(tensor, root_rank, name=None):
    """Broadcast with upstream's registered gradient: backward
    reduces every rank's gradient to the root, zeros elsewhere
    (upstream: tensorflow/mpi_ops.py _broadcast_grad)."""
    t = tf.convert_to_tensor(tensor)

    def _grad(dy):
        # densify: IndexedSlices neither multiply by 0 nor stay meaningful
        # after the root-only zeroing
        dy = tf.convert_to_tensor(dy)
        grad_reduced = allreduce(
            dy, average=False,
            name=None if name is None else f"{name}.grad")
        if rank() != root_rank:
            grad_reduced = grad_reduced * 0
        return grad_reduced

    if hasattr(t, "numpy"):
        @tf.custom_gradient
        def _bc(x):
            out = tf.cast(tf.convert_to_tensor(
                _broadcast(x.numpy(), root_rank, name=name)), x.dtype)
            return out, _grad

        return _bc(t)

    # Graph mode (tf.function / compat.v1 graphs): same py_function hop to
    # the host engine the allreduce bridge uses.
    @tf.custom_gradient
    def _bc_graph(x):
        def wire(z):
            return tf.cast(tf.convert_to_tensor(
                _broadcast(z.numpy(), root_rank, name=name)), z.dtype)

        out = tf.py_function(wire, [x], Tout=x.dtype)
        out.set_shape(x.shape)
        return out, _grad

    return _bc_graph(t)


def broadcast_variables(variables, root_rank):
    """Assign every variable its root-rank value
    (upstream: broadcast_variables, tensorflow/__init__.py:95-105)."""
    for i, var in enumerate(variables):
        var.assign(broadcast(tf.convert_to_tensor(var), root_rank,
                             name=f"broadcast_var.{i}.{var.name}"))


def broadcast_global_variables(root_rank):
    """Broadcast the TF1-compat global-variables collection from root_rank
    (upstream: tensorflow/__init__.py:85-92). Populated only for graphs
    built through tf.compat.v1 (Variable creation registers there); in
    native TF2 eager code the collection is empty — broadcast explicit
    variable lists with broadcast_variables(model.variables, root) instead.

    In graph mode returns the grouped assign op (run it in your session,
    like upstream); eagerly it executes and returns None."""
    gvars = tf.compat.v1.global_variables()
    if not gvars:
        raise NotImplementedError(
            "broadcast_global_variables found no TF1-collection variables "
            "(native TF2 code does not register any); use "
            "broadcast_variables(model.variables, root_rank) instead.")
    if tf.compat.v1.executing_eagerly():
        broadcast_variables(gvars, root_rank)
        return None
    assigns = [
        tf.compat.v1.assign(
            var, broadcast(var.read_value(), root_rank,
                           name=f"broadcast_global.{i}"))
        for i, var in enumerate(gvars)]
    return tf.group(*assigns)


class BroadcastGlobalVariablesHook(tf.compat.v1.train.SessionRunHook):
    """SessionRunHook broadcasting all global variables from root_rank
    after session creation — upstream's TF1 checkpoint-consistency
    helper (upstream: BroadcastGlobalVariablesHook,
    tensorflow/__init__.py:107-138). Usable with
    tf.compat.v1.train.MonitoredTrainingSession; tf.estimator itself was
    removed from TF in 2.16, so the estimator wiring has no living API."""

    def __init__(self, root_rank, device=""):
        super().__init__()
        self.root_rank = root_rank
        self.bcast_op = None
        del device  # the engine places the exchange

    def begin(self):
        self.bcast_op = broadcast_global_variables(self.root_rank)

    def after_create_session(self, session, coord):
        session.run(self.bcast_op)


class DistributedGradientTape(tf.GradientTape):
    """tf.GradientTape whose gradient() allreduces the grads
    (upstream: DistributedGradientTape, tensorflow/__init__.py:242-316)."""

    def __init__(self, tape=None, device_dense="", device_sparse="",
                 compression=Compression.none, sparse_as_dense=False,
                 persistent=None, watch_accessed_variables=None):
        super().__init__(
            persistent=bool(persistent),
            watch_accessed_variables=(watch_accessed_variables
                                      if watch_accessed_variables is not None
                                      else True))
        if tape is not None:
            # Take OWNERSHIP of the wrapped tape's recorded state so
            # already-taped computation is differentiable through the
            # wrapper — upstream passes the inner tape into the
            # subclass the same way (tensorflow/__init__.py:246-252,
            # 308-316). Only the fields gradient() needs are transferred
            # (not the whole __dict__: sharing every attribute would leave
            # two owners of one pywrap tape, and a non-persistent
            # gradient() on both would pop the same C++ tape twice).
            # After wrapping, call gradient() on the wrapper only.
            for attr in ("_tape", "_recording", "_created_eagerly"):
                if hasattr(tape, attr):
                    setattr(self, attr, getattr(tape, attr))
            self._persistent = (persistent if persistent is not None
                                else tape._persistent)
            if watch_accessed_variables is not None:
                self._watch_accessed_variables = watch_accessed_variables
            elif hasattr(tape, "_watch_accessed_variables"):
                self._watch_accessed_variables = \
                    tape._watch_accessed_variables
            # neuter the donor so a stray gradient() on it cannot release
            # the transferred pywrap tape underneath us
            tape._tape = None
            tape._recording = False
        self._compression_ = compression
        self._sparse_as_dense = sparse_as_dense

    def gradient(self, target, sources, output_gradients=None):
        grads = super().gradient(target, sources, output_gradients)
        out = []
        for i, g in enumerate(grads):
            if g is None:
                out.append(None)
                continue
            if isinstance(g, tf.IndexedSlices) and self._sparse_as_dense:
                g = tf.convert_to_tensor(g)
            out.append(allreduce(g, average=True,
                                 compression=self._compression_,
                                 name=f"gradtape.{i}"))
        return out


def _make_distributed_optimizer_class(base, compression=None,
                                      sparse_as_dense=False):
    """Subclass a keras optimizer class so apply_gradients allreduces
    first. Shared by DistributedOptimizer (instance wrapping) and the
    keras load_model re-mapping (class wrapping; upstream:
    _keras/__init__.py:93-109)."""
    compression = compression or Compression.none

    class _Distributed(base):
        def apply_gradients(self, grads_and_vars, **kwargs):
            reduced = []
            for i, (g, v) in enumerate(grads_and_vars):
                if g is None:
                    reduced.append((g, v))
                    continue
                if isinstance(g, tf.IndexedSlices) and sparse_as_dense:
                    g = tf.convert_to_tensor(g)
                g = allreduce(g, average=True, compression=compression,
                              name=f"gradopt.{i}.{v.name}")
                reduced.append((g, v))
            return super().apply_gradients(reduced, **kwargs)

    _Distributed.__name__ = "Distributed" + base.__name__
    _Distributed._hvd_distributed_wrapper = True  # load_model skips these
    return _Distributed


def DistributedOptimizer(optimizer, name=None, use_locking=False,
                         device_dense="", device_sparse="",
                         compression=Compression.none,
                         sparse_as_dense=False):
    """Wrap a tf.keras optimizer so apply_gradients allreduces first
    (upstream: DistributedOptimizer, tensorflow/__init__.py:141-239 — there
    it overrides compute_gradients; TF2 keras optimizers expose
    apply_gradients as the hook point)."""
    del name, use_locking, device_dense, device_sparse
    cls = _make_distributed_optimizer_class(
        optimizer.__class__, compression=compression,
        sparse_as_dense=sparse_as_dense)
    return cls.from_config(optimizer.get_config())
