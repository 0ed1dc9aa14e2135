"""Inference serving on one card: continuous-batching decode over a
paged KV cache (counterpart of horovod_tpu/serve/).

Layers, bottom-up:

- :mod:`~horovod_tpu_torch.serve.kv_cache` — the paged pool's host-side
  allocator: page tables, alloc/free/defrag, the null page 0.
- :mod:`~horovod_tpu_torch.serve.engine` — shape-binned prefill (through
  the flash kernel) and paged decode.
- :mod:`~horovod_tpu_torch.serve.scheduler` — iteration-level continuous
  batching: bounded admission, per-step join/evict, page-governed
  capacity.
- :mod:`~horovod_tpu_torch.serve.api` — ``Engine(model, params)`` with
  ``submit()``/``stream()`` and the SLO signal.
"""

from .api import Engine, Stream
from .engine import ServeEngine
from .kv_cache import OutOfPages, PagedKVCache
from .scheduler import ContinuousBatcher, Request, ServeOverloaded

__all__ = ["Engine", "Stream", "ServeEngine", "PagedKVCache",
           "OutOfPages", "ContinuousBatcher", "Request",
           "ServeOverloaded"]
