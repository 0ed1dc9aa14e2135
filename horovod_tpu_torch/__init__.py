"""horovod_tpu_torch: the port of horovod_tpu to PyTorch and CUDA on
NVIDIA Hopper (H100).

horovod_tpu (JAX on a TPU) stays the reference. This package grows
slice by slice (ROADMAP.md); so far it serves and trains the flagship
transformer, with attention through hand-written sm_90a flash-attention
kernels (ops/csrc/flash_fwd.cu, ops/csrc/flash_bwd.cu), averages
gradients over data-parallel ranks, and runs the hot loop (the training
step, serving's shape bins, ``generate``'s decode steps) as CUDA
graphs:

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
"""

from . import models, serve
from .exceptions import HorovodError, NotInitializedError, ShutDownError
from .ops.collectives import (allgather, allreduce, broadcast,
                              exchange_bucket_plan, grouped_allreduce)
from .ops.compression import Compression
from .ops.step_program import CompiledTrainStep, compiled_train_step
from .optimizers import (DistributedOptimizer, broadcast_optimizer_state,
                         broadcast_parameters)
from .runtime import (AXIS, cross_rank, cross_size, init, is_initialized,
                      local_rank, local_size, mesh, rank, shutdown, size)

__version__ = "0.2.0"

__all__ = [
    "AXIS", "CompiledTrainStep", "Compression", "DistributedOptimizer",
    "HorovodError",
    "NotInitializedError", "ShutDownError", "__version__", "allgather",
    "allreduce", "broadcast", "broadcast_optimizer_state",
    "broadcast_parameters", "compiled_train_step", "cross_rank",
    "cross_size",
    "exchange_bucket_plan", "grouped_allreduce", "init", "is_initialized",
    "local_rank", "local_size", "mesh", "models", "rank", "serve",
    "shutdown", "size",
]
