"""Environment-variable configuration of the port.

Counterpart of horovod_tpu/config.py, carrying what the serving and
training slices read: the five ``HOROVOD_SERVE_*`` knobs, the elastic
policy directory the SLO signal is dropped into, the ZeRO stage, the
exchange bucket count, the compiled hot loop's switches
(``HOROVOD_STEP_PROGRAM``, ``HOROVOD_STEP_PROGRAM_CHURN_LIMIT``,
``HOROVOD_DEVICE_RESIDENT``), the profiler dump and its per-replay
records (``HOROVOD_PROFILER_JIT_CALLBACKS``), the MFU peak, the knobs of
subsystems the port does not have yet (``init()`` refuses them), and
:func:`next_power_of_two` (the shape bins). Names, defaults and clamps
are the JAX package's.
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


def _env_flag(name):
    return os.environ.get(name, "") not in ("", "0", "false", "False")


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
    # ZeRO sharding stage DistributedOptimizer uses when the call site
    # passes none (0 = replicated allreduce; 1-3 are not ported yet).
    zero_stage: int = 0
    # Gradient-exchange buckets of DistributedOptimizer: byte-balanced,
    # reverse-layer groups, each one fused all-reduce launched from the
    # backward as soon as its gradients are ready (1 = one exchange).
    exchange_buckets: int = 1
    # Device-resident mode: -1 = auto, 1 = on, 0 = host mode, where
    # compiled_train_step runs every step eagerly (reason host_mode).
    device_resident: int = -1
    # Compiled hot loop (ops/step_program.py): compiled_train_step, the
    # serve engine and generate run CUDA graphs on a card. -1 = auto
    # (on unless device_resident is 0); 0 = every step eager (reason
    # disabled); 1 = on even under HOROVOD_DEVICE_RESIDENT=0.
    step_program: int = -1
    # Distinct signatures one CompiledTrainStep captures before each
    # further new one runs eagerly (reason shape_churn). Minimum 1.
    step_program_churn_limit: int = 8
    # Per-collective stats dump written by rank 0 at shutdown
    # (profiler.txt, the fork's layout).
    profiler_path: str = "profiler.txt"
    profiler_disable: bool = False
    # Record a captured program's collectives (as ``<op>_jit``) on every
    # replay, not only once when the program is captured.
    profiler_jit_callbacks: bool = False
    # Knobs of subsystems the port does not have yet; init() refuses a
    # set one rather than ignore it.
    timeline: str = ""
    guard: bool = False
    autotune: bool = False
    metrics_dir: str = ""
    metrics_port: int = -1
    dcn_compression: str = ""
    # Per-chip peak FLOP/s for MFU (0 = look the card up in hardware.py).
    peak_flops: float = 0.0

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
        c.zero_stage = min(max(_env_int("HOROVOD_ZERO_STAGE",
                                        c.zero_stage), 0), 3)
        c.exchange_buckets = max(_env_int("HOROVOD_EXCHANGE_BUCKETS",
                                          c.exchange_buckets), 1)
        c.device_resident = _env_int("HOROVOD_DEVICE_RESIDENT",
                                     c.device_resident)
        c.step_program = _env_int("HOROVOD_STEP_PROGRAM", c.step_program)
        c.step_program_churn_limit = max(_env_int(
            "HOROVOD_STEP_PROGRAM_CHURN_LIMIT",
            c.step_program_churn_limit), 1)
        c.profiler_path = os.environ.get("HOROVOD_PROFILER_PATH",
                                         c.profiler_path)
        c.profiler_disable = _env_flag("HOROVOD_PROFILER_DISABLE")
        c.profiler_jit_callbacks = _env_flag(
            "HOROVOD_PROFILER_JIT_CALLBACKS")
        c.timeline = os.environ.get("HOROVOD_TIMELINE", "")
        c.guard = _env_flag("HOROVOD_GUARD")
        c.autotune = _env_flag("HOROVOD_AUTOTUNE")
        c.metrics_dir = os.environ.get("HOROVOD_METRICS_DIR", "")
        c.metrics_port = _env_int("HOROVOD_METRICS_PORT", c.metrics_port)
        c.dcn_compression = os.environ.get("HOROVOD_DCN_COMPRESSION",
                                           c.dcn_compression)
        c.peak_flops = max(_env_float("HOROVOD_PEAK_FLOPS", c.peak_flops),
                           0.0)
        return c


def step_program_enabled(cfg):
    """True when the compiled hot loop runs programs (graphs on a card):
    ``HOROVOD_STEP_PROGRAM=1``, or auto with device residency not off."""
    return cfg.step_program == 1 or (cfg.step_program != 0
                                     and cfg.device_resident != 0)


def next_power_of_two(n):
    """Round up to the next power of two."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())
