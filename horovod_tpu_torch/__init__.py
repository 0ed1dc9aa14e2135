"""horovod_tpu_torch: the port of horovod_tpu to PyTorch and CUDA on
NVIDIA Hopper (H100).

horovod_tpu (JAX on a TPU) stays the reference. This package grows
slice by slice (ROADMAP.md); so far it serves and trains the flagship
transformer, with attention through hand-written sm_90a flash-attention
kernels (ops/csrc/flash_fwd.cu, ops/csrc/flash_bwd.cu), averages
gradients over data-parallel ranks (replicated, or ZeRO-sharded at
stages 1-3 with an optional two-stage exchange whose cross-host hop is
bf16 or int8), trains and serves Mixture-of-Experts layers
(expert-parallel over a process group), trains and serves the flagship
Megatron-sharded over a model group (the 3-D (data, expert, model)
mesh), and runs the hot loop (the
training step, serving's shape bins, ``generate``'s decode steps) as
CUDA graphs:

    import horovod_tpu_torch as hvd
    hvd.init()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(..., capturable=True),
                                   named_parameters=model.named_parameters())
    step = hvd.compiled_train_step(model.loss, opt)
    loss = step(tokens, targets)

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs
instead.

The top-level ``allreduce``, ``allgather``, ``broadcast`` and
``alltoall``, their ``_async`` and in-place (``_``) forms, ``poll`` and
``synchronize`` go through the eager engine (ops/engine.py): named,
negotiated across ranks, fused, cached and stall-checked, as in the
reference; the synchronous forms are autograd functions
(:class:`HorovodAllreduce`, :class:`HorovodAllgather`,
:class:`HorovodBroadcast`). ``horovod_tpu_torch.ops.collectives`` stays
the direct path the optimizer, ZeRO, tensor, expert and sequence
parallelism run on, as ``horovod_tpu.ops`` is the jit path beside the
JAX package's eager API.

Diagnostics (diag/): ``hvd.trace_steps(n)`` (or ``HOROVOD_XPROF_STEPS``)
captures the next n steps with ``torch.profiler`` and attributes their
device time to the step's phases, replayed CUDA graphs included; the
flight recorder, the hang watchdog, the perf sentry and the metrics
exporters follow their knobs (``HOROVOD_FLIGHT_BUFFER``,
``HOROVOD_STALL_TIMEOUT_SECONDS``, ``HOROVOD_PERF_SENTRY``,
``HOROVOD_METRICS_DIR`` / ``HOROVOD_METRICS_PORT``), and
``callbacks.TelemetryCallback`` gives a training loop its step
telemetry.

Fault tolerance: ``guard`` (``HOROVOD_GUARD``: health rows on the
reduced gradients, the skip / learning-rate back-off / rollback ladder,
inside the compiled step's CUDA graph too; the divergence probe; the
``HOROVOD_GUARD_INJECT`` chaos grammar), ``elastic`` (``elastic.run``,
``elastic.State``, the rendezvous over the job's store, the preemption
grace, the supervisor's and autoscaler's policies), ``checkpoint``
(``CheckpointManager`` with sidecar digests) and ``data``
(``DistributedDataset``: seeded sharding, pinned-memory prefetch, a
position that re-shards over the survivors of an elastic recovery).
``init(comm=[...])`` runs a job on a subset of the launched ranks.

Launching and tuning, as in the JAX package, are subpackages imported by
name: ``python -m horovod_tpu_torch.run -np N cmd`` (``run``: gang
restart, elastic supervision with autoscale, the RPC driver and task
services), ``autotune`` (``HOROVOD_AUTOTUNE``: the eager engine's fusion
threshold, cycle time, padding and depth, tuned on process 0) and
``controlplane.simrank`` (simulated ranks against the coordinator). So
are ``spark`` (``spark.run(fn, num_proc=N)``: one Spark task, or local
process, a rank) and the framework bindings ``tensorflow`` (with
``tensorflow.keras``), ``keras`` and ``mxnet``, which exchange through
the eager engine; importing this package imports none of them, nor
TensorFlow or MXNet. So is ``analysis``: hvdlint over the port (``python
-m horovod_tpu_torch.analysis``) and the lock-order witness.
"""

import torch

from . import callbacks, diag, metrics, models, serve, timeline
from .exceptions import (CheckpointCorruptError, CoordinatorError,
                         DuplicateNameError, HorovodError, HostsUpdatedError,
                         MismatchError, NotInitializedError, ShutDownError,
                         StalledTensorError, TransientCollectiveError,
                         WorkerLostError)
from .negotiation import ALLGATHER, ALLREDUCE, ALLTOALL, BROADCAST
from .ops import collectives as _collectives
from .ops.collectives import (alltoall_chunked,
                              bucketed_reducescatter_allgather,
                              exchange_bucket_plan, grouped_allreduce,
                              hierarchical_allreduce, reducescatter)
from .ops.compression import (Compression, Compressor, FP16Compressor,
                               NoneCompressor)
from .diag.xla_trace import trace_steps
from .ops.step_program import CompiledTrainStep, compiled_train_step
from .optimizers import (DistributedOptimizer, broadcast_optimizer_state,
                         broadcast_parameters, exchange_gradients,
                         guarded_apply_updates, resize_lr_factor)
from .runtime import (AXIS, cross_rank, cross_size, expert_mesh,
                      expert_parallel_size, init, is_initialized, local_rank,
                      local_size, mesh, model_mesh, model_parallel_size,
                      mpi_threads_supported, rank, shutdown, size)

__version__ = "0.2.0"


def metrics_snapshot():
    """The process's metric families as a dict (metrics.py
    ``snapshot``): the engine, coordinator, collective, step and guard
    counters. Works before ``init()`` too: the families exist at import
    and read zero."""
    return metrics.snapshot()


# Auto-generated names for unnamed ops, parity with the reference's
# "allreduce.noname.%d" counters (torch/mpi_ops_v2.cc:58-62). Every rank
# names its unnamed ops in the order it submits them.
_noname_counters = {}
# (engine, handle) -> the tensor an in-place form writes its result into
_outputs = {}


def _auto_name(op):
    n = _noname_counters.get(op, 0)
    _noname_counters[op] = n + 1
    return f"{op}.noname.{n + 1}"


def _engine():
    from .runtime import engine
    return engine()


def _first(result):
    """Engine results are ``{rank: tensor}`` (one rank a process)."""
    if isinstance(result, dict):
        return result[min(result)]
    return result


def _inplace(handle, tensor):
    _outputs[(id(_engine()), handle)] = tensor
    return handle


# ---------------------------------------------------------------- eager ops

def allreduce_async(tensor, average=True, name=None,
                    compression=Compression.none, rank=None, to_host=True):
    """Asynchronous allreduce; returns a handle for poll()/synchronize()
    (reference: torch/mpi_ops.py:85-120). ``compression`` narrows the
    wire dtype. ``to_host`` is the JAX package's flag, accepted and
    ignored: the result always lies on the input's device
    (ops/engine.py)."""
    del to_host
    if name is None:
        name = _auto_name("allreduce")
    comp = None if compression is Compression.none else compression
    return _engine().enqueue(ALLREDUCE, tensor, name, rank=rank,
                             average=average, compression=comp)


class HorovodAllreduce(torch.autograd.Function):
    """Autograd allreduce: the backward of a (linear) allreduce is the
    same allreduce of the incoming gradient
    (reference: torch/mpi_ops.py:110-121)."""

    @staticmethod
    def forward(ctx, tensor, average, name, compression):
        ctx.average = average
        return synchronize(allreduce_async(tensor, average=average,
                                           name=name,
                                           compression=compression))

    @staticmethod
    def backward(ctx, grad_output):
        return allreduce(grad_output, average=ctx.average), None, None, None


def allreduce(tensor, average=True, name=None, compression=Compression.none):
    """Average (default) or sum of ``tensor`` over all ranks, on its
    device (reference: torch/mpi_ops.py:122-154); gradients flow if the
    input requires them."""
    return HorovodAllreduce.apply(tensor, average, name, compression)


def allreduce_async_(tensor, average=True, name=None, rank=None):
    """In-place async allreduce: ``synchronize`` writes the result into
    ``tensor`` (reference: torch/mpi_ops.py:157-176)."""
    if name is None:
        name = _auto_name("allreduce")
    return _inplace(_engine().enqueue(ALLREDUCE, tensor, name, rank=rank,
                                      average=average, inplace=True),
                    tensor)


def allreduce_(tensor, average=True, name=None):
    """(reference: torch/mpi_ops.py:179-197)"""
    return synchronize(allreduce_async_(tensor, average=average, name=name))


def allgather_async(tensor, name=None, rank=None):
    """Asynchronous allgather (reference: torch/mpi_ops.py:200-231)."""
    if name is None:
        name = _auto_name("allgather")
    return _engine().enqueue(ALLGATHER, tensor, name, rank=rank)


class HorovodAllgather(torch.autograd.Function):
    """Autograd allgather: backward sums every rank's gradient and takes
    this rank's dim-0 slice (reference: torch/mpi_ops.py:236-254)."""

    @staticmethod
    def forward(ctx, tensor, name):
        ctx.dim = tensor.shape[0]
        return synchronize(allgather_async(tensor, name=name))

    @staticmethod
    def backward(ctx, grad_output):
        grad_reduced = allreduce(grad_output, average=False)
        dims = allgather(torch.tensor([ctx.dim], dtype=torch.int32))
        r = rank()
        offset = int(dims[:r].sum()) if r else 0
        return grad_reduced.narrow(0, offset, ctx.dim), None


def allgather(tensor, name=None):
    """Every rank's tensor concatenated along dim 0, which may differ
    across ranks (reference: torch/mpi_ops.py:233-262)."""
    return HorovodAllgather.apply(tensor, name)


def broadcast_async(tensor, root_rank, name=None, rank=None):
    """Asynchronous broadcast (reference: torch/mpi_ops.py:282-315)."""
    if name is None:
        name = _auto_name("broadcast")
    return _engine().enqueue(BROADCAST, tensor, name, rank=rank,
                             root_rank=root_rank)


class HorovodBroadcast(torch.autograd.Function):
    """Autograd broadcast: backward reduces every rank's gradient to the
    root; non-root ranks get zero (reference: torch/mpi_ops.py:322-337)."""

    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return synchronize(broadcast_async(tensor, root_rank, name=name))

    @staticmethod
    def backward(ctx, grad_output):
        grad_reduced = allreduce(grad_output, average=False)
        if rank() != ctx.root_rank:
            grad_reduced = grad_reduced * 0
        return grad_reduced, None, None


def broadcast(tensor, root_rank, name=None):
    """Every rank receives root_rank's tensor
    (reference: torch/mpi_ops.py:317-347)."""
    return HorovodBroadcast.apply(tensor, root_rank, name)


def broadcast_async_(tensor, root_rank, name=None, rank=None):
    """In-place async broadcast (reference: torch/mpi_ops.py:350-379)."""
    if name is None:
        name = _auto_name("broadcast")
    return _inplace(_engine().enqueue(BROADCAST, tensor, name, rank=rank,
                                      root_rank=root_rank), tensor)


def broadcast_(tensor, root_rank, name=None):
    """(reference: torch/mpi_ops.py:382-401)"""
    return synchronize(broadcast_async_(tensor, root_rank, name=name))


def alltoall(tensor, name=None, split_axis=0, concat_axis=0, group=None):
    """Scatter equal dim-0 slices to every rank and gather the slices
    received, in rank order, through the engine (named and negotiated).
    Other axes or a sub-group take the direct, differentiable collective
    (ops/collectives.py ``alltoall``) that expert parallelism runs on."""
    if split_axis != 0 or concat_axis != 0 or group is not None:
        return _collectives.alltoall(tensor, group=group,
                                     split_axis=split_axis,
                                     concat_axis=concat_axis)
    if name is None:
        name = _auto_name("alltoall")
    return synchronize(_engine().enqueue(ALLTOALL, tensor, name))


def poll(handle):
    """True once the async op completed (reference: torch/mpi_ops.py:404-419)."""
    return _engine().poll(handle)


def synchronize(handle):
    """Wait for an async op; returns its output, written into the input
    for the in-place forms (reference: torch/mpi_ops.py:422-438)."""
    eng = _engine()
    target = _outputs.pop((id(eng), handle), None)
    out = _first(eng.synchronize(handle))
    if target is None:
        return out
    if out.data_ptr() != target.data_ptr():
        target.copy_(out)
    return target


__all__ = [
    "AXIS", "CompiledTrainStep", "Compression", "Compressor",
    "CoordinatorError", "FP16Compressor", "NoneCompressor",
    "DistributedOptimizer", "DuplicateNameError", "HorovodAllgather",
    "HorovodAllreduce", "HorovodBroadcast", "HorovodError", "MismatchError",
    "NotInitializedError", "ShutDownError", "StalledTensorError",
    "__version__", "allgather", "allgather_async", "allreduce",
    "allreduce_", "allreduce_async", "allreduce_async_", "alltoall",
    "alltoall_chunked", "broadcast", "broadcast_", "broadcast_async",
    "broadcast_async_", "broadcast_optimizer_state", "broadcast_parameters",
    "poll", "synchronize",
    "bucketed_reducescatter_allgather", "compiled_train_step", "cross_rank",
    "cross_size", "exchange_gradients", "expert_mesh",
    "expert_parallel_size", "exchange_bucket_plan", "grouped_allreduce",
    "hierarchical_allreduce",
    "init", "is_initialized", "local_rank", "local_size", "mesh",
    "metrics_snapshot", "model_mesh", "model_parallel_size", "models",
    "mpi_threads_supported", "rank", "reducescatter",
    "serve", "shutdown", "size", "trace_steps",
    "CheckpointCorruptError", "HostsUpdatedError",
    "TransientCollectiveError", "WorkerLostError", "callbacks",
    "checkpoint", "data", "elastic", "guard", "guarded_apply_updates",
    "resize_lr_factor", "timeline",
]

# The fault-tolerance modules, after the API they use.
from . import checkpoint, data, elastic, guard  # noqa: E402,F401
