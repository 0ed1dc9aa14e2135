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
records (``HOROVOD_PROFILER_JIT_CALLBACKS``), the MFU peak, the eager
engine's and its coordinator's knobs (fusion threshold, cycle time,
response cache, timeline, stall checks, overlap pipeline, padding, wire
profile, the control plane's tree, graduation and bypass, the KV
client's retries), the step-integrity guard's (``HOROVOD_GUARD*``),
elastic training's (``HOROVOD_ELASTIC*``) and the input pipeline's
(``HOROVOD_DATA_PREFETCH``), autotune's (``HOROVOD_AUTOTUNE*``), the
launcher's (``HOROVOD_START_TIMEOUT``, ``HOROVOD_LAUNCH_RPC``,
``HOROVOD_ELASTIC_DRAIN_SECONDS``), the Spark driver's
(``HOROVOD_SPARK_START_TIMEOUT``), the logger's level and time stamps
(``HOROVOD_LOG_LEVEL``, ``HOROVOD_LOG_HIDE_TIME``, which
utils/logging.py reads through :meth:`Config.from_env`),
:data:`FUSION_BUFFER_ATOMIC_UNIT` and
:func:`next_power_of_two` (the shape bins). Names, defaults and clamps
are the JAX package's. Two of its fields are left out: the engine's
local tier is ``dcn_local_size`` (``HOROVOD_TPU_LOCAL_SIZE`` is the
launcher's variable here), and ``autotune_gaussian_process_noise`` is
read by nothing there either. ``fusion_donate`` is read and ignored:
torch donates no buffer to a program.
"""

import dataclasses
import os

# Fusion-buffer alignment unit, bytes (reference: operations.h:30).
FUSION_BUFFER_ATOMIC_UNIT = 64


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
    # Autotune (autotune.py; reference: operations.cc:1228-1244).
    autotune: bool = False
    autotune_log: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_bayes_opt_max_samples: int = 20
    # Launcher (run/): seconds each worker gets to reach its first
    # rendezvous before the job is declared failed, and the opt-in that
    # forces the RPC driver/task-service launch path for local hosts.
    start_timeout: int = 30
    launch_rpc: bool = False
    # SIGTERM -> SIGKILL escalation of the launcher's and task services'
    # teardown, and the supervisor's allowance past the grace window
    # (run/ reads it from the job's environment, which may differ from
    # this process's).
    elastic_drain_seconds: float = 3.0
    # Spark driver: seconds to wait for every task to register.
    spark_start_timeout: int = 600
    # Step-integrity guard (guard/). Off by default, and then nothing
    # changes: no health rows, no gate, the plain programs. With it on,
    # every bad step is skipped; after guard_lr_backoff_steps
    # consecutive bad steps the learning rate is multiplied by
    # guard_lr_backoff_factor; after guard_bad_step_limit consecutive bad
    # steps training rolls back to the last elastic.State commit.
    guard: bool = False
    guard_bad_step_limit: int = 3
    guard_lr_backoff_steps: int = 2
    guard_lr_backoff_factor: float = 0.5
    # Cross-replica divergence probe cadence in steps (0 = off).
    guard_divergence_interval: int = 0
    # Bounded retry of a transient collective failure (0 = none).
    guard_retry: int = 0
    guard_retry_deadline_seconds: float = 30.0
    guard_retry_base_seconds: float = 0.05
    # Deterministic chaos injection (guard/inject.py); '' = none.
    guard_inject: str = ""
    # Input pipeline (data/loader.py): batches staged ahead (0 = inline).
    data_prefetch: int = 2
    # The eager engine (ops/engine.py). Tensor fusion threshold in bytes
    # (reference: operations.cc:1176-1186), coordination cycle time in ms
    # (operations.cc:1196-1203), response cache capacity
    # (global_state.h:169).
    fusion_threshold: int = 64 * 1024 * 1024
    cycle_time_ms: float = 5.0
    cache_capacity: int = 1024
    # Timeline output path ('' disables) and its cycle markers
    # (reference: operations.cc:1164-1171, timeline.h:97).
    timeline: str = ""
    timeline_mark_cycles: bool = False
    # Stall checks (reference: global_state.h:70-78).
    stall_check_disable: bool = False
    stall_check_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 0.0
    # Two-level allreduce and allgather of the eager engine over
    # (cross, local) groups of dcn_local_size ranks (0: the launcher's
    # HOROVOD_TPU_LOCAL_SIZE).
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # The JAX package's XLA buffer donation of the fusion buffer: read
    # and ignored (a torch collective writes its buffer in place).
    fusion_donate: int = -1
    # Full request lists every cycle instead of the coordinator's
    # epoch-token bypass (measurement knob), and no control-plane ticker.
    coordinator_bypass_disable: bool = False
    ticker_disable: bool = False
    # Pod-scale control plane (controlplane/): tree fan-in group size
    # (< 2 off) and static-schedule graduation after this many identical
    # rounds (0 off), with the graduated processes' log refresh bound.
    coord_tree_fanout: int = 0
    coord_graduate_after: int = 0
    coord_graduate_refresh_seconds: float = 2.0
    # Fused buckets dispatched but not yet completed at once (0: each
    # bucket completes inline).
    pipeline_depth: int = 2
    # Elastic training (elastic/): liveness beacons and the lost-worker
    # scan, the process group's timeout (elastic_timeout_seconds: a
    # collective with a dead peer fails within it as WorkerLostError),
    # the rendezvous settle window, and the SIGTERM preemption grace.
    elastic: bool = False
    elastic_timeout_seconds: float = 10.0
    elastic_settle_seconds: float = 1.0
    elastic_grace_seconds: float = 0.0
    elastic_grace_dir: str = ""
    # The fork's padding experiment: fused element counts rounded up to
    # a power of two (reference fork: ops/mpi_operations.cc:24-63).
    padding_algo: int = 0
    # The fork's wire profiler: hvd_wire_seconds by power-of-two size
    # bin, dumped to profiler.csv at shutdown.
    wire_profile: bool = False
    wire_profile_path: str = "profiler.csv"
    # Control-plane KV client (utils/kvstore.py) connection retries.
    kv_retries: int = 2
    kv_retry_base_seconds: float = 0.05
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
    # the ICI group size (ranks a host; 0 = the launcher's local size),
    # also the eager engine's local tier under hierarchical allreduce.
    dcn_compression: str = ""
    dcn_local_size: int = 0
    # Per-chip peak FLOP/s for MFU (0 = look the card up in hardware.py).
    peak_flops: float = 0.0
    # Logging (utils/logging.py): level name (trace, debug, info,
    # warning, error, fatal; case-insensitive) and whether the time
    # stamp is left out of each line.
    log_level: str = "WARNING"
    log_hide_time: bool = False

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
        c.fusion_threshold = _env_int("HOROVOD_FUSION_THRESHOLD",
                                      c.fusion_threshold)
        c.cycle_time_ms = _env_float("HOROVOD_CYCLE_TIME", c.cycle_time_ms)
        c.cache_capacity = _env_int("HOROVOD_CACHE_CAPACITY",
                                    c.cache_capacity)
        c.timeline = os.environ.get("HOROVOD_TIMELINE", "")
        c.timeline_mark_cycles = _env_flag("HOROVOD_TIMELINE_MARK_CYCLES")
        c.stall_check_disable = _env_flag("HOROVOD_STALL_CHECK_DISABLE")
        c.stall_check_time_seconds = _env_float(
            "HOROVOD_STALL_CHECK_TIME_SECONDS", c.stall_check_time_seconds)
        c.stall_shutdown_time_seconds = _env_float(
            "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
            c.stall_shutdown_time_seconds)
        c.hierarchical_allreduce = _env_flag("HOROVOD_HIERARCHICAL_ALLREDUCE")
        c.hierarchical_allgather = _env_flag("HOROVOD_HIERARCHICAL_ALLGATHER")
        c.fusion_donate = _env_int("HOROVOD_FUSION_DONATE", c.fusion_donate)
        c.coordinator_bypass_disable = _env_flag(
            "HOROVOD_COORDINATOR_BYPASS_DISABLE")
        c.ticker_disable = _env_flag("HOROVOD_TPU_TICKER_DISABLE")
        c.coord_tree_fanout = max(_env_int("HOROVOD_COORD_TREE_FANOUT",
                                           c.coord_tree_fanout), 0)
        c.coord_graduate_after = max(_env_int("HOROVOD_COORD_GRADUATE_AFTER",
                                              c.coord_graduate_after), 0)
        c.coord_graduate_refresh_seconds = max(_env_float(
            "HOROVOD_COORD_GRADUATE_REFRESH_SECONDS",
            c.coord_graduate_refresh_seconds), 0.05)
        c.pipeline_depth = max(_env_int("HOROVOD_PIPELINE_DEPTH",
                                        c.pipeline_depth), 0)
        c.elastic = _env_flag("HOROVOD_ELASTIC")
        c.elastic_timeout_seconds = _env_float(
            "HOROVOD_ELASTIC_TIMEOUT_SECONDS", c.elastic_timeout_seconds)
        c.elastic_settle_seconds = _env_float(
            "HOROVOD_ELASTIC_SETTLE_SECONDS", c.elastic_settle_seconds)
        c.elastic_grace_seconds = _env_float(
            "HOROVOD_ELASTIC_GRACE_SECONDS", c.elastic_grace_seconds)
        c.elastic_grace_dir = os.environ.get("HOROVOD_ELASTIC_GRACE_DIR",
                                             c.elastic_grace_dir)
        c.data_prefetch = max(_env_int("HOROVOD_DATA_PREFETCH",
                                       c.data_prefetch), 0)
        c.padding_algo = _env_int("PADDING_ALGO", 0)
        c.wire_profile = _env_flag("HOROVOD_WIRE_PROFILE")
        c.wire_profile_path = os.environ.get("HOROVOD_WIRE_PROFILE_PATH",
                                             c.wire_profile_path)
        c.kv_retries = max(_env_int("HOROVOD_KV_RETRIES", c.kv_retries), 0)
        c.kv_retry_base_seconds = _env_float(
            "HOROVOD_KV_RETRY_BASE_SECONDS", c.kv_retry_base_seconds)
        c.guard = _env_flag("HOROVOD_GUARD")
        c.guard_bad_step_limit = max(_env_int(
            "HOROVOD_GUARD_BAD_STEPS", c.guard_bad_step_limit), 1)
        c.guard_lr_backoff_steps = max(_env_int(
            "HOROVOD_GUARD_LR_BACKOFF_STEPS", c.guard_lr_backoff_steps), 1)
        c.guard_lr_backoff_factor = _env_float(
            "HOROVOD_GUARD_LR_BACKOFF_FACTOR", c.guard_lr_backoff_factor)
        c.guard_divergence_interval = max(_env_int(
            "HOROVOD_GUARD_DIVERGENCE_INTERVAL",
            c.guard_divergence_interval), 0)
        c.guard_retry = max(_env_int("HOROVOD_GUARD_RETRY",
                                     c.guard_retry), 0)
        c.guard_retry_deadline_seconds = _env_float(
            "HOROVOD_GUARD_RETRY_DEADLINE_SECONDS",
            c.guard_retry_deadline_seconds)
        c.guard_retry_base_seconds = _env_float(
            "HOROVOD_GUARD_RETRY_BASE_SECONDS", c.guard_retry_base_seconds)
        c.guard_inject = os.environ.get("HOROVOD_GUARD_INJECT",
                                        c.guard_inject)
        c.autotune = _env_flag("HOROVOD_AUTOTUNE")
        c.autotune_log = os.environ.get("HOROVOD_AUTOTUNE_LOG", "")
        c.autotune_warmup_samples = _env_int("HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
                                             c.autotune_warmup_samples)
        c.autotune_steps_per_sample = _env_int(
            "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", c.autotune_steps_per_sample)
        c.start_timeout = max(_env_int("HOROVOD_START_TIMEOUT",
                                       c.start_timeout), 1)
        c.launch_rpc = _env_flag("HOROVOD_LAUNCH_RPC")
        c.elastic_drain_seconds = _env_float(
            "HOROVOD_ELASTIC_DRAIN_SECONDS", c.elastic_drain_seconds)
        c.spark_start_timeout = max(_env_int(
            "HOROVOD_SPARK_START_TIMEOUT", c.spark_start_timeout), 1)
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
        # The profiler.txt and profiler.csv dumps default into
        # HOROVOD_METRICS_DIR, else HOROVOD_DIAG_DIR, when no explicit
        # path overrides them.
        home = c.metrics_dir or c.diag_dir
        if home:
            if "HOROVOD_PROFILER_PATH" not in os.environ:
                c.profiler_path = os.path.join(home, "profiler.txt")
            if "HOROVOD_WIRE_PROFILE_PATH" not in os.environ:
                c.wire_profile_path = os.path.join(home, "profiler.csv")
        c.log_level = os.environ.get("HOROVOD_LOG_LEVEL", c.log_level)
        c.log_hide_time = _env_flag("HOROVOD_LOG_HIDE_TIME")
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
