"""horovod_tpu_torch.mxnet: the MXNet binding over the eager engine.

Counterpart of horovod_tpu/mxnet/ (upstream: horovod/mxnet/: the
engine's async push ops, mpi_ops.py:46-160; ``DistributedOptimizer``
with the ``rescale_grad`` average, __init__.py:38-74; gluon's
``DistributedTrainer``, :83-102; ``broadcast_parameters`` with the
deferred-initialization hook, :105-150).

NDArrays cross to the port's eager engine as numpy, held there as CPU
torch tensors (negotiation, fusion, the response cache and the timeline
all apply), and the results are written back; an op completes before
it returns, which gives ``wait_to_read`` its meaning. ``priority`` is
accepted and ignored: the engine launches in its decision order.

MXNet must be importable, and it is installed neither here nor on the
machine with the card (the project is retired): importing this module
then raises ImportError, as upstream's ``check_extension`` does
(horovod/common/util.py:41).
"""

import types
import warnings

try:
    import mxnet as mx
except ImportError as e:
    raise ImportError(
        "horovod_tpu_torch.mxnet requires the 'mxnet' package, which is "
        "not installed (MXNet is retired and has no CUDA 12 build). Use "
        "horovod_tpu_torch (PyTorch) or horovod_tpu_torch.tensorflow; the "
        "API surface is allreduce/allgather/broadcast + "
        "DistributedOptimizer in each.") from e

import numpy as np
import torch

import horovod_tpu_torch as _hvd
from horovod_tpu_torch.runtime import (init, local_rank, local_size,
                                       mpi_threads_supported, rank,
                                       shutdown, size)

__all__ = [
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "mpi_threads_supported", "allreduce", "allreduce_", "allgather",
    "broadcast", "broadcast_", "DistributedOptimizer", "DistributedTrainer",
    "broadcast_parameters",
]


def _to_torch(tensor):
    """An NDArray's values as a CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(tensor.asnumpy()))


def _numpy(out):
    return out.detach().cpu().numpy()


def _like(tensor, arr):
    """New NDArray with ``arr``'s data on ``tensor``'s context/dtype."""
    return mx.nd.array(np.ascontiguousarray(arr), ctx=tensor.context,
                       dtype=tensor.dtype)


def allreduce(tensor, average=True, name=None, priority=0):
    """Average (default) or sum of ``tensor`` over all ranks; returns a new
    NDArray (upstream: horovod/mxnet/mpi_ops.py:46-84)."""
    del priority
    out = _hvd.allreduce(_to_torch(tensor), average=average, name=name)
    return _like(tensor, _numpy(out))


def allreduce_(tensor, average=True, name=None, priority=0):
    """In-place allreduce (upstream: horovod/mxnet/mpi_ops.py:87-119)."""
    del priority
    out = _hvd.allreduce(_to_torch(tensor), average=average, name=name)
    tensor[:] = _numpy(out)
    return tensor


def allgather(tensor, name=None, priority=0):
    """Concatenation of every rank's tensor along dim 0
    (upstream: horovod/mxnet/mpi_ops.py:122-151)."""
    del priority
    out = _hvd.allgather(_to_torch(tensor), name=name)
    return _like(tensor, _numpy(out))


def broadcast(tensor, root_rank, name=None, priority=0):
    """Every rank receives root_rank's tensor; returns a new NDArray
    (upstream: horovod/mxnet/mpi_ops.py:154-186)."""
    del priority
    out = _hvd.broadcast(_to_torch(tensor), root_rank, name=name)
    return _like(tensor, _numpy(out))


def broadcast_(tensor, root_rank, name=None, priority=0):
    """In-place broadcast (upstream: horovod/mxnet/mpi_ops.py:189-218)."""
    del priority
    out = _hvd.broadcast(_to_torch(tensor), root_rank, name=name)
    tensor[:] = _numpy(out)
    return tensor


def _exchange_grads(indexed_grads):
    """Wire exchange for one update call: submit every gradient's summed
    allreduce, in index order. The engine's fusion planner batches the
    in-flight set into few collectives, which is what upstream's
    ``priority=-i`` engine hint tries to arrange from MXNet's side — the
    hint itself has nothing to reorder here and is not forwarded."""
    for idx, grad in indexed_grads:
        allreduce_(grad, average=False, name=f"mx.grad.{idx}")


def _as_indexed_list(index, grad):
    """MXNet's Optimizer.update may be called with a scalar index or a
    batch of (indices, grads); normalize to pairs."""
    if isinstance(index, (tuple, list)):
        return list(zip(index, grad))
    return [(index, grad)]


class DistributedOptimizer(mx.optimizer.Optimizer):
    """Optimizer wrapper: each update first sum-allreduces the gradients,
    and the 1/size averaging rides the wrapped optimizer's
    ``rescale_grad`` (MXNet applies rescale_grad to every gradient inside
    update, so dividing it by world size turns the wire sum into the
    average without a second pass over the data).

    API-parity note (upstream: horovod/mxnet/__init__.py:38-74): the
    overridden method NAMES below are dictated by the
    ``mx.optimizer.Optimizer`` interface — ``update`` /
    ``update_multi_precision`` are the exact entry points MXNet's Module
    and Trainer machinery invokes, and the state/mutator methods are
    defined on the base class, so ``__getattr__`` alone cannot delegate
    them (Python finds the base implementation first). The delegation
    mechanism — a generated forwarder per base-defined method — is this
    module's own.
    """

    def __init__(self, optimizer):
        # No super().__init__: the wrapped optimizer's state must stay the
        # single source of truth, and every attribute read falls through
        # to it via __getattr__.
        self._optimizer = optimizer
        self._optimizer.rescale_grad /= size()

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def update(self, index, weight, grad, state):
        _exchange_grads(_as_indexed_list(index, grad))
        self._optimizer.update(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        _exchange_grads(_as_indexed_list(index, grad))
        self._optimizer.update_multi_precision(index, weight, grad, state)


def _forward_to_wrapped(name):
    def forwarder(self, *args, **kwargs):
        return getattr(self._optimizer, name)(*args, **kwargs)
    forwarder.__name__ = name
    forwarder.__doc__ = (f"Forward {name} to the wrapped optimizer "
                         "(base-class method, unreachable via __getattr__).")
    return forwarder


for _name in ("create_state", "create_state_multi_precision",
              "set_learning_rate", "set_lr_mult", "set_wd_mult"):
    setattr(DistributedOptimizer, _name, _forward_to_wrapped(_name))
del _name


class DistributedTrainer(mx.gluon.Trainer):
    """gluon Trainer whose gradient exchange is the engine's allreduce
    instead of kvstore push/pull; averaging rides the trainer's ``_scale``
    the same way rescale_grad does above.

    API-parity note (upstream: horovod/mxnet/__init__.py:83-102): the
    constructor signature and the ``_allreduce_grads`` override point are
    gluon's Trainer contract (it calls ``_allreduce_grads`` between
    backward and update); ``kvstore=None`` is required so gluon doesn't
    run its own exchange on top.
    """

    def __init__(self, params, optimizer, optimizer_params=None):
        if isinstance(optimizer, DistributedOptimizer):
            warnings.warn(
                "DistributedTrainer expects a plain MXNet optimizer; the "
                "DistributedOptimizer passed in was unwrapped so gradients "
                "are not exchanged twice.")
            optimizer = optimizer._optimizer
        super().__init__(params, optimizer,
                         optimizer_params=optimizer_params, kvstore=None)
        self._scale /= size()

    def _allreduce_grads(self):
        live = ((i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null")
        _exchange_grads((f"param.{i}", p.list_grad()[0]) for i, p in live)


def _inject_broadcast_after_init(param, root_rank):
    """Deferred-init parameters (shape not yet inferred) cannot broadcast
    now; chain the broadcast onto the parameter's materialization hook so
    it runs the moment data exists. ``_init_impl`` is gluon's internal
    materialization point — the one place a deferred parameter is
    guaranteed to gain data (upstream hooks the same method,
    horovod/mxnet/__init__.py:105-113)."""
    original = param._init_impl

    def init_then_broadcast(self, *args, **kwargs):
        original(*args, **kwargs)
        broadcast_(self.data(), root_rank=root_rank)
        self.data().wait_to_read()

    param._init_impl = types.MethodType(init_then_broadcast, param)


def broadcast_parameters(params, root_rank=0):
    """Broadcast ``Module.get_params()`` / ``Block.collect_params()`` from
    root_rank; parameters still awaiting shape inference get the broadcast
    injected into their initializer
    (upstream: horovod/mxnet/__init__.py:116-150)."""
    tensors = []
    if isinstance(params, dict):
        # Covers both plain dicts of tensors (Module.get_params()) and
        # Parameter-valued dicts: gluon's ParameterDict (MXNet 1.x, may
        # subclass dict) and MXNet 2.x collect_params(), which returns a
        # plain dict of Parameters. Parameters are recognized by their
        # data()/deferred-init protocol.
        for _, p in sorted(params.items()):
            if hasattr(p, "data") and callable(p.data):
                try:
                    tensors.append(p.data())
                except mx.gluon.parameter.DeferredInitializationError:
                    _inject_broadcast_after_init(p, root_rank)
            else:
                tensors.append(p)
    else:
        raise ValueError("invalid params of type: %s" % type(params))

    # Submit every broadcast before waiting on any, so the engine's fusion
    # planner batches them into few collectives (upstream gets this from
    # MXNet's async engine push).
    handles = [_hvd.broadcast_async(_to_torch(t), root_rank, name=str(i))
               for i, t in enumerate(tensors)]
    for tensor, handle in zip(tensors, handles):
        tensor[:] = _numpy(_hvd._first(_hvd.synchronize(handle)))

    for tensor in tensors:
        tensor.wait_to_read()
