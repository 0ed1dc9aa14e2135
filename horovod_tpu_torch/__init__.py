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

Diagnostics (diag/): ``hvd.trace_steps(n)`` (or ``HOROVOD_XPROF_STEPS``)
captures the next n steps with ``torch.profiler`` and attributes their
device time to the step's phases, replayed CUDA graphs included; the
flight recorder, the hang watchdog, the perf sentry and the metrics
exporters follow their knobs (``HOROVOD_FLIGHT_BUFFER``,
``HOROVOD_STALL_TIMEOUT_SECONDS``, ``HOROVOD_PERF_SENTRY``,
``HOROVOD_METRICS_DIR`` / ``HOROVOD_METRICS_PORT``), and
``callbacks.TelemetryCallback`` gives a training loop its step
telemetry.
"""

from . import callbacks, diag, metrics, models, serve
from .exceptions import HorovodError, NotInitializedError, ShutDownError
from .ops.collectives import (allgather, allreduce, alltoall,
                              alltoall_chunked, broadcast,
                              bucketed_reducescatter_allgather,
                              exchange_bucket_plan, grouped_allreduce,
                              hierarchical_allreduce, reducescatter)
from .ops.compression import Compression
from .diag.xla_trace import trace_steps
from .ops.step_program import CompiledTrainStep, compiled_train_step
from .optimizers import (DistributedOptimizer, broadcast_optimizer_state,
                         broadcast_parameters)
from .runtime import (AXIS, cross_rank, cross_size, expert_mesh,
                      expert_parallel_size, init, is_initialized, local_rank,
                      local_size, mesh, model_mesh, model_parallel_size,
                      rank, shutdown, size)

__version__ = "0.2.0"

__all__ = [
    "AXIS", "CompiledTrainStep", "Compression", "DistributedOptimizer",
    "HorovodError",
    "NotInitializedError", "ShutDownError", "__version__", "allgather",
    "allreduce", "alltoall", "alltoall_chunked", "broadcast",
    "broadcast_optimizer_state", "broadcast_parameters",
    "bucketed_reducescatter_allgather", "compiled_train_step", "cross_rank",
    "cross_size", "expert_mesh", "expert_parallel_size",
    "exchange_bucket_plan", "grouped_allreduce", "hierarchical_allreduce",
    "init", "is_initialized", "local_rank", "local_size", "mesh",
    "model_mesh", "model_parallel_size", "models", "rank", "reducescatter",
    "serve", "shutdown", "size", "trace_steps",
]
