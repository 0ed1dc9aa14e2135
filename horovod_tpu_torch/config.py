"""Environment-variable configuration of the port.

Counterpart of horovod_tpu/config.py, carrying what the serving slice
reads: the five ``HOROVOD_SERVE_*`` knobs, the elastic policy directory
the SLO signal is dropped into, and :func:`next_power_of_two` (the shape
bins). Names, defaults and clamps are the JAX package's.
"""

import dataclasses
import os


def _env_int(name, default):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        return default


def _env_float(name, default):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        return default


@dataclasses.dataclass
class Config:
    # Pool size of the paged KV cache in pages (page 0 is the reserved
    # null page) and tokens per page.
    serve_pages: int = 512
    serve_page_size: int = 16
    # Continuous-batch width cap and the bounded admission queue's depth.
    serve_max_batch: int = 8
    serve_queue_depth: int = 64
    # Per-token p99 latency SLO exported next to the queue depth.
    serve_slo_p99_seconds: float = 0.5
    # Where the serve engine drops its SLO signal file ('' disables).
    elastic_policy_dir: str = ""

    @classmethod
    def from_env(cls):
        c = cls()
        c.serve_pages = max(_env_int("HOROVOD_SERVE_PAGES", c.serve_pages),
                            2)
        c.serve_page_size = max(_env_int("HOROVOD_SERVE_PAGE_SIZE",
                                         c.serve_page_size), 1)
        c.serve_max_batch = max(_env_int("HOROVOD_SERVE_MAX_BATCH",
                                         c.serve_max_batch), 1)
        c.serve_queue_depth = max(_env_int("HOROVOD_SERVE_QUEUE_DEPTH",
                                           c.serve_queue_depth), 1)
        c.serve_slo_p99_seconds = max(_env_float(
            "HOROVOD_SERVE_SLO_P99_SECONDS", c.serve_slo_p99_seconds), 0.0)
        c.elastic_policy_dir = os.environ.get("HOROVOD_ELASTIC_POLICY_DIR",
                                              c.elastic_policy_dir)
        return c


def next_power_of_two(n):
    """Round up to the next power of two."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())
