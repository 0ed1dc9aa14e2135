"""Environment-variable configuration of the port.

Counterpart of horovod_tpu/config.py, carrying what the serving and
training slices read: the five ``HOROVOD_SERVE_*`` knobs, the elastic
policy directory the SLO signal is dropped into, the ZeRO stage and its
reduce-scatter chunk (``HOROVOD_REDUCE_SCATTER_BUCKET``), the staged
exchange's DCN wire and ICI group size (``HOROVOD_DCN_COMPRESSION``,
``HOROVOD_DCN_LOCAL_SIZE``), the exchange bucket count, the
expert-parallel and model-parallel degrees and the MoE all-to-all chunks
(``HOROVOD_EXPERT_PARALLEL``, ``HOROVOD_MODEL_PARALLEL``,
``HOROVOD_MOE_CHUNKS``), the compiled hot
loop's switches (``HOROVOD_STEP_PROGRAM``,
``HOROVOD_STEP_PROGRAM_CHURN_LIMIT``, ``HOROVOD_DEVICE_RESIDENT``), the
profiler dump and its per-replay
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
    # passes none (0 = replicated allreduce, 1 = optimizer state,
    # 2 = + gradients, 3 = + parameters).
    zero_stage: int = 0
    # Byte size of one chunk of the ZeRO-2/3 reduce-scatter and of one
    # bucket of bucketed_reducescatter_allgather (minimum 1).
    reduce_scatter_bucket: int = 32 * 1024 * 1024
    # Gradient-exchange buckets of DistributedOptimizer: byte-balanced,
    # reverse-layer groups, each one fused all-reduce launched from the
    # backward as soon as its gradients are ready (1 = one exchange).
    exchange_buckets: int = 1
    # Expert-parallel degree: > 1 makes init() lay the ranks out as
    # (world/ep, ep) with axes ("hvd", "ep"), expert axis innermost
    # (parallel/mesh.py expert_data_mesh). Must divide the world size.
    expert_parallel: int = 1
    # Tensor (model) parallelism degree of the dense trunk: > 1 makes
    # init() lay the ranks out as (world/(ep*mp), ep, mp) with axes
    # ("hvd", "ep", "model"), model axis innermost (parallel/mesh.py
    # model_expert_data_mesh). expert_parallel * model_parallel must
    # divide the world size.
    model_parallel: int = 1
    # Capacity slices the MoE dispatch/combine all-to-all is split into
    # (ops/collectives.py alltoall_chunked); 1 = unchunked. Numerics are
    # bit-identical at every setting; a value that does not divide the
    # capacity falls back to its largest divisor below.
    moe_chunks: int = 1
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
    # Runtime metrics exporters (metrics.py). metrics_dir enables the JSONL
    # + Prometheus-textfile sinks; metrics_port >= 0 enables the HTTP scrape
    # endpoint (0 binds an ephemeral port); metrics_interval is the export
    # cadence in seconds (also the device-memory sampling floor).
    metrics_dir: str = ""
    metrics_port: int = -1
    # Scrape-endpoint bind address. Loopback by default: /metrics is
    # unauthenticated, so reaching it from another host (a Prometheus
    # scraper) is an explicit opt-in (HOROVOD_METRICS_BIND=0.0.0.0).
    metrics_bind: str = "127.0.0.1"
    metrics_interval: float = 10.0
    # Collective flight recorder + hang diagnosis (diag/). flight_buffer
    # is the per-rank ring capacity in events (rounded up to a power of
    # two; 0 disables recording). stall_timeout_seconds > 0 starts the
    # hang watchdog: any collective in flight past the timeout triggers a
    # durable flight dump and (on process 0) a desync report; 0 (default)
    # is fully inert — no thread, no beacons. diag_dir is where
    # flight-rank<N>.json / desync-report.json land ('' = CWD when a dump
    # is triggered).
    flight_buffer: int = 4096
    stall_timeout_seconds: float = 0.0
    diag_dir: str = ""
    # On-demand device tracing (diag/xla_trace.py). xprof_steps > 0 arms
    # a one-shot capture at init: the first N steps are recorded with
    # torch.profiler into a xla-trace-<seq> directory under diag_dir and
    # parsed into per-phase device-time totals (hvd.trace_steps(n) is the
    # programmatic form). 0 (default) is fully inert — no tracer object,
    # no profiler state.
    xprof_steps: int = 0
    # Perf-regression sentry (diag/sentry.py): per-signature EMA
    # baseline of step time and MFU persisted under metrics_dir as
    # perf-baseline.json. A step slower (or an MFU lower) than the
    # baseline by more than perf_sentry_threshold increments
    # hvd_perf_regressions_total, records a flight-recorder event and
    # auto-arms one trace window. Off (default) = no state, no I/O.
    perf_sentry: bool = False
    perf_sentry_threshold: float = 0.25
    # Two-stage exchange: the DCN hop's wire ("", "bf16" or "int8") and
    # the ICI group size (ranks a host; 0 = the launcher's local size).
    dcn_compression: str = ""
    dcn_local_size: int = 0
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
        c.expert_parallel = max(_env_int("HOROVOD_EXPERT_PARALLEL",
                                         c.expert_parallel), 1)
        c.model_parallel = max(_env_int("HOROVOD_MODEL_PARALLEL",
                                        c.model_parallel), 1)
        c.moe_chunks = max(_env_int("HOROVOD_MOE_CHUNKS",
                                    c.moe_chunks), 1)
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
        c.metrics_bind = os.environ.get("HOROVOD_METRICS_BIND",
                                        c.metrics_bind)
        c.metrics_interval = _env_float("HOROVOD_METRICS_INTERVAL",
                                        c.metrics_interval)
        c.flight_buffer = max(_env_int("HOROVOD_FLIGHT_BUFFER",
                                       c.flight_buffer), 0)
        c.stall_timeout_seconds = _env_float(
            "HOROVOD_STALL_TIMEOUT_SECONDS", c.stall_timeout_seconds)
        c.diag_dir = os.environ.get("HOROVOD_DIAG_DIR", c.diag_dir)
        c.xprof_steps = max(_env_int("HOROVOD_XPROF_STEPS",
                                     c.xprof_steps), 0)
        c.perf_sentry = _env_flag("HOROVOD_PERF_SENTRY")
        c.perf_sentry_threshold = max(_env_float(
            "HOROVOD_PERF_SENTRY_THRESHOLD", c.perf_sentry_threshold), 0.0)
        c.reduce_scatter_bucket = max(_env_int(
            "HOROVOD_REDUCE_SCATTER_BUCKET", c.reduce_scatter_bucket), 1)
        c.dcn_compression = os.environ.get("HOROVOD_DCN_COMPRESSION",
                                           c.dcn_compression)
        c.dcn_local_size = max(_env_int("HOROVOD_DCN_LOCAL_SIZE",
                                        c.dcn_local_size), 0)
        c.peak_flops = max(_env_float("HOROVOD_PEAK_FLOPS", c.peak_flops),
                           0.0)
        # The profiler.txt dump defaults into HOROVOD_METRICS_DIR, else
        # HOROVOD_DIAG_DIR, when no explicit path overrides it.
        if "HOROVOD_PROFILER_PATH" not in os.environ:
            if c.metrics_dir:
                c.profiler_path = os.path.join(c.metrics_dir, "profiler.txt")
            elif c.diag_dir:
                c.profiler_path = os.path.join(c.diag_dir, "profiler.txt")
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
