"""Process-wide metrics registry: labeled counters, gauges, histograms,
and the export sinks.

Counterpart of horovod_tpu/metrics.py, carrying the registry core with
its collect hooks, the serving families (``hvd_serve_*``, program
caches included), the compiled hot loop's families (``hvd_step_*``:
cache, fallbacks, FLOPs and MFU), the training loop's telemetry
(``hvd_steps_total``, ``hvd_step_seconds``, ``hvd_examples_per_sec``,
the skew gauges), the runtime lifecycle and device-memory families
(``hvd_device_*``, read from ``torch.cuda.memory_stats``), the
per-collective mirror of stats.py, the ZeRO and staged-exchange
families (``hvd_zero_*``, ``hvd_wire_stage_*``, ``hvd_spec_leaves``),
the model-parallel degree (``hvd_model_parallel``), the
expert-parallel MoE families (``hvd_moe_*``, fed by
:func:`record_moe_step`), the overlap fractions a phase trace reads
(``hvd_moe_alltoall_hidden_frac``, ``hvd_exchange_hidden_frac``) and
the diagnostics families (``hvd_diag_*``, ``hvd_xla_*``,
``hvd_perf_regressions_total``; diag/), under the JAX package's names
and help texts. The ``xla`` in a name is kept so a dashboard finds the
same series: in the port the trace is ``torch.profiler``'s.

The sinks (:class:`MetricsExporters`): a JSONL log of snapshots and a
Prometheus textfile under ``HOROVOD_METRICS_DIR``, and an HTTP scrape
endpoint on ``HOROVOD_METRICS_PORT``, every ``HOROVOD_METRICS_INTERVAL``
seconds, in the JAX package's formats. Its third sink, counter events
spliced into the live timeline, waits for the timeline (ROADMAP.md,
Queue 1 item 10): the ``timeline`` argument must be None.
"""

import json
import os
import threading
import time

from .utils.logging import get_logger

_logger = get_logger("horovod_tpu_torch.metrics")

# Latency histogram bounds, seconds.
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labelnames, labelvalues):
    """Canonical child key: the inner part of a Prometheus series."""
    return ",".join(f'{n}="{_escape(str(v))}"'
                    for n, v in zip(labelnames, labelvalues))


def _escape(s):
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Family:
    """Base of one named metric family holding labeled children."""

    kind = "untyped"

    def __init__(self, registry, name, help, labelnames):
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children = {}

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = _label_key(self.labelnames,
                         [labelvalues[n] for n in self.labelnames])
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _default_child(self):
        """The unlabeled child, for families with no labelnames."""
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels {self.labelnames}")
        with self._lock:
            child = self._children.get("")
            if child is None:
                child = self._children[""] = self._new_child()
            return child

    def collect(self):
        """{label_key: value} snapshot of every child."""
        with self._lock:
            return {k: c.value() for k, c in self._children.items()}


class _CounterChild:
    __slots__ = ("_v", "_lock")

    def __init__(self, lock):
        self._v = 0.0
        self._lock = lock

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._v += amount

    def value(self):
        return self._v


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _CounterChild(self._lock)

    def inc(self, amount=1.0):
        self._default_child().inc(amount)

    def value(self):
        return self._default_child().value()


class _GaugeChild:
    __slots__ = ("_v", "_lock")

    def __init__(self, lock):
        self._v = 0.0
        self._lock = lock

    def set(self, v):
        with self._lock:
            self._v = float(v)

    def inc(self, amount=1.0):
        with self._lock:
            self._v += amount

    def value(self):
        return self._v


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild(self._lock)

    def set(self, v):
        self._default_child().set(v)

    def inc(self, amount=1.0):
        self._default_child().inc(amount)

    def value(self):
        return self._default_child().value()


class _HistogramChild:
    __slots__ = ("_buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets, lock):
        self._buckets = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0
        self._lock = lock

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, bound in enumerate(self._buckets):
                if v <= bound:
                    self._counts[i] += 1  # per-bucket; cumulated at read
                    break

    def value(self):
        with self._lock:
            cum, out = 0, {}
            for bound, c in zip(self._buckets, self._counts):
                cum += c
                out[str(bound)] = cum
            out["+Inf"] = self._count
            return {"count": self._count, "sum": self._sum, "buckets": out}


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets=LATENCY_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        self.buckets = tuple(sorted(buckets))

    def _new_child(self):
        return _HistogramChild(self.buckets, self._lock)

    def observe(self, v):
        self._default_child().observe(v)

    def value(self):
        return self._default_child().value()


class MetricsRegistry:
    """Thread-safe, label-aware registry of counters/gauges/histograms."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families = {}       # name -> _Family, insertion-ordered
        self._collect_hooks = {}  # owner key -> callable()

    def _register(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(f"{name} already registered as "
                                     f"{fam.kind}, not {cls.kind}")
                return fam
            fam = self._families[name] = cls(self, name, help, labelnames,
                                             **kw)
            return fam

    def counter(self, name, help="", labelnames=()):
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=LATENCY_BUCKETS):
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def set_collect_hook(self, owner, fn):
        """Register or replace a callback run before every snapshot, keyed
        by owner so a re-init replaces its predecessor's hook."""
        with self._lock:
            self._collect_hooks[owner] = fn

    def remove_collect_hook(self, owner):
        with self._lock:
            self._collect_hooks.pop(owner, None)

    def snapshot(self):
        """``{name: {"type", "help", "values"}}``; values map a label key
        (empty for unlabeled) to a float or a histogram's
        ``{count, sum, buckets}``. Runs the collect hooks first."""
        with self._lock:
            hooks = list(self._collect_hooks.items())
        for owner, fn in hooks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — telemetry must not kill work
                _logger.debug("metrics collect hook %r failed", owner,
                              exc_info=True)
        with self._lock:
            return {name: {"type": fam.kind, "help": fam.help,
                           "values": fam.collect()}
                    for name, fam in self._families.items()}


_registry = MetricsRegistry()


def registry():
    """The process-wide registry."""
    return _registry


def snapshot():
    """``hvd.metrics_snapshot()``: the full current snapshot."""
    return _registry.snapshot()


def compact_snapshot():
    """Snapshot restricted to families with at least one non-zero series;
    histograms reduce to ``{count, sum}``. This is what the benches
    embed in their one-line JSON, without a thousand zero rows."""
    out = {}
    for name, fam in _registry.snapshot().items():
        vals = {}
        for key, v in fam["values"].items():
            if isinstance(v, dict):
                if v["count"]:
                    vals[key] = {"count": v["count"],
                                 "sum": round(v["sum"], 6)}
            elif v:
                vals[key] = v
        if vals:
            out[name] = vals
    return out


# Inference serving (serve/)
SERVE_REQUESTS = _registry.counter(
    "hvd_serve_requests_total",
    "Serve requests by lifecycle outcome: admitted (queued), rejected "
    "(admission queue full — the backpressure path), completed "
    "(stream finished, pages freed).", labelnames=("outcome",))
SERVE_ACTIVE_SEQUENCES = _registry.gauge(
    "hvd_serve_active_sequences",
    "Sequences currently holding KV pages and decoding in the "
    "continuous batch.")
SERVE_QUEUE_DEPTH = _registry.gauge(
    "hvd_serve_queue_depth",
    "Requests waiting in the bounded admission queue (including one "
    "popped-but-unadmitted head waiting for pages); an elasticity "
    "signal.")
SERVE_KV_FREE_PAGES = _registry.gauge(
    "hvd_serve_kv_free_pages",
    "KV cache pages on the free list (the admission-capacity "
    "currency: a request joins only when its whole lifetime fits).")
SERVE_KV_PAGE_UTILIZATION = _registry.gauge(
    "hvd_serve_kv_page_utilization",
    "Allocated fraction of the allocatable KV page pool (page 0, the "
    "null page, excluded).")
SERVE_TOKENS = _registry.counter(
    "hvd_serve_tokens_total",
    "Tokens processed by the serve engine: phase=prefill counts prompt "
    "tokens ingested, phase=decode counts tokens generated.",
    labelnames=("phase",))
SERVE_STEP_SECONDS = _registry.histogram(
    "hvd_serve_step_seconds",
    "Wall time of one serve engine call (launch + device + fetch) by "
    "phase (prefill/decode).", buckets=LATENCY_BUCKETS,
    labelnames=("phase",))
SERVE_TTFT_SECONDS = _registry.histogram(
    "hvd_serve_ttft_seconds",
    "Time to first token: request submission to the first generated "
    "token leaving the prefill that admitted it (queue wait "
    "included).", buckets=LATENCY_BUCKETS)
SERVE_TOKEN_LATENCY_SECONDS = _registry.histogram(
    "hvd_serve_token_latency_seconds",
    "Interval between a stream's consecutive generated tokens (the "
    "per-token decode latency the serving SLO is written against).",
    buckets=LATENCY_BUCKETS)
SERVE_P99_LATENCY_SECONDS = _registry.gauge(
    "hvd_serve_p99_latency_seconds",
    "Sliding-window p99 of hvd_serve_token_latency_seconds "
    "observations — the value exported to the autoscale policy next "
    "to queue depth.")
SERVE_PROGRAM_CACHE_HITS = _registry.gauge(
    "hvd_serve_program_cache_hits",
    "Serve program fetches served from cache, by phase; steady state "
    "is one executable per live shape bin, so the decode hit rate "
    "(hits / (hits + misses)) sits >= 0.9 after warmup — the CI "
    "serve-smoke gate.", labelnames=("phase",))
SERVE_PROGRAM_CACHE_MISSES = _registry.gauge(
    "hvd_serve_program_cache_misses",
    "Serve program fetches that built (compiled) a new executable, by "
    "phase; growth after warmup means shape bins are churning "
    "(docs/troubleshooting.md \"my decode step keeps recompiling\").",
    labelnames=("phase",))
SERVE_FALLBACK_STEPS = _registry.counter(
    "hvd_serve_fallback_steps_total",
    "Serve steps that fell back to a process-local program cache "
    "because the engine's step-program tier errored; the serve bench "
    "and CI assert this stays 0.")
SERVE_JOINS = _registry.counter(
    "hvd_serve_joins_total",
    "Sequences admitted into the continuous batch (each join is one "
    "prefill ride-along, between decode steps).")
SERVE_EVICTIONS = _registry.counter(
    "hvd_serve_evictions_total",
    "Sequences removed from the continuous batch, by reason: "
    "finished (token budget), eos (stop token), cancelled (client "
    "gone); every eviction returns its pages to the free list.",
    labelnames=("reason",))

# Compiled step program (ops/step_program.py): on a card each program
# is a captured CUDA graph, where the JAX package compiles an XLA one.
STEP_PROGRAM_CACHE_HITS = _registry.gauge(
    "hvd_step_program_cache_hits",
    "Engine step-program cache hits (signature-keyed compiled train "
    "steps); steady-state training should hit on every step after "
    "warmup.")
STEP_PROGRAM_CACHE_MISSES = _registry.gauge(
    "hvd_step_program_cache_misses",
    "Engine step-program cache misses — each one is a full XLA "
    "recompile of the fused train step (docs/troubleshooting.md \"my "
    "compiled step keeps recompiling\").")
STEP_COMPILED_TOTAL = _registry.counter(
    "hvd_step_compiled_total",
    "Training steps executed through the compiled hot loop (one donated "
    "XLA program: forward, backward, exchange, optimizer apply).")
STEP_FALLBACK_TOTAL = _registry.counter(
    "hvd_step_fallback_total",
    "compiled_train_step calls that ran the eager/legacy step instead, "
    "by reason (disabled | host_mode | shape_churn).",
    labelnames=("reason",))
STEP_FLOPS_TOTAL = _registry.counter(
    "hvd_step_flops_total",
    "Cumulative whole-program FLOPs executed by the compiled hot loop, "
    "from XLA cost_analysis on each step-program signature (all chips; "
    "divide by hvd_ranks for per-chip work).")
STEP_MFU = _registry.gauge(
    "hvd_step_mfu",
    "Model FLOPs utilization of the most recent compiled step: "
    "per-chip cost_analysis FLOPs / (step wall time x peak chip FLOPs). "
    "Peak comes from the device kind or HOROVOD_PEAK_FLOPS; 0 when "
    "neither is known (e.g. CPU without the override).")

# Runtime lifecycle (runtime.py)
RUNTIME_INITS = _registry.counter(
    "hvd_init_total", "hvd.init() calls completed.")
RUNTIME_SHUTDOWNS = _registry.counter(
    "hvd_shutdown_total", "hvd.shutdown() calls completed.")
RUNTIME_UP = _registry.gauge(
    "hvd_up", "1 while the runtime is initialized, else 0.")
RUNTIME_RANKS = _registry.gauge(
    "hvd_ranks", "Total ranks (chips) in the current job.")
DEVICE_BYTES_IN_USE = _registry.gauge(
    "hvd_device_bytes_in_use", "Device memory in use "
    "(jax.Device.memory_stats, backends that report it).",
    labelnames=("device",))
DEVICE_PEAK_BYTES = _registry.gauge(
    "hvd_device_peak_bytes_in_use", "Peak device memory in use.",
    labelnames=("device",))
DEVICE_BYTES_LIMIT = _registry.gauge(
    "hvd_device_bytes_limit", "Device memory capacity.",
    labelnames=("device",))

# Training loop (callbacks.TelemetryCallback)
STEPS_TOTAL = _registry.counter(
    "hvd_steps_total", "Training steps observed by TelemetryCallback.")
STEP_SECONDS = _registry.histogram(
    "hvd_step_seconds", "Per-step wall time.")
EXAMPLES_PER_SEC = _registry.gauge(
    "hvd_examples_per_sec", "Examples/sec from the most recent step.")
STEP_SKEW = _registry.gauge(
    "hvd_step_time_skew", "Straggler skew: max/median of per-rank step "
    "times at the last skew sample.")
STEP_SKEW_MAX = _registry.gauge(
    "hvd_step_seconds_max", "Slowest rank's step time at the last skew "
    "sample.")
STEP_SKEW_MEDIAN = _registry.gauge(
    "hvd_step_seconds_median", "Median rank step time at the last skew "
    "sample.")

# Per-collective mirror of stats.py (fork parity registry; values reset
# with each session's stats object, hence gauges).
COLLECTIVE_CALLS = _registry.gauge(
    "hvd_collective_calls", "Collective calls recorded by the fork-parity "
    "stats registry (profiler.txt counters).", labelnames=("op",))
COLLECTIVE_TIME_US = _registry.gauge(
    "hvd_collective_time_us", "Cumulative wall time per collective, "
    "microseconds (profiler.txt Time rows).", labelnames=("op",))

# ZeRO sharding + DCN-staged exchange (optimizers.py zero_stage=1|2|3,
# ops/collectives.py dcn_staged_*)
ZERO_STAGE = _registry.gauge(
    "hvd_zero_stage",
    "ZeRO sharding stage of the most recently constructed "
    "DistributedOptimizer (0 = replicated, 1 = optimizer state, "
    "2 = +gradients, 3 = +parameters).")
ZERO_STRIPE_BYTES = _registry.gauge(
    "hvd_zero_stripe_bytes",
    "Per-device bytes of this rank's 1/N stripe, by kind "
    "(params | grads | opt): the sharded footprint the ZeRO ladder "
    "trades wire time for.", labelnames=("kind",))
WIRE_STAGE_BYTES = _registry.counter(
    "hvd_wire_stage_bytes_total",
    "Wire bytes recorded at trace time for each tier of the DCN-staged "
    "exchange (stage = ici | dcn). The dcn slot counts the COMPRESSED "
    "width (int8 codes count 1 byte/element even though the XLA "
    "emulation carries an int32 accumulator).", labelnames=("stage",))
WIRE_STAGE_RAW_BYTES = _registry.counter(
    "hvd_wire_stage_raw_bytes_total",
    "Uncompressed bytes the same staged exchanges would have moved — "
    "1 - wire/raw is the compression saving per stage "
    "(bench.py dcn_bytes_saved_frac).", labelnames=("stage",))
WIRE_STAGE_SECONDS = _registry.histogram(
    "hvd_wire_stage_seconds",
    "Measured per-step device time inside each tier of the staged "
    "exchange (stage = ici | dcn), attributed from the XLA device "
    "trace's hvd_ici/hvd_dcn scopes — the latency counterpart of "
    "hvd_wire_stage_bytes_total. One observation per traced capture "
    "window.", labelnames=("stage",))

# Composable parallelism (optimizers.py _ShardingSpec, parallel/mesh.py
# model_expert_data_mesh)
MODEL_PARALLEL = _registry.gauge(
    "hvd_model_parallel",
    "Model (tensor-parallel) axis size of the runtime's 3-D "
    "(data, expert, model) mesh, set at hvd.init() from "
    "HOROVOD_MODEL_PARALLEL; 1 = no model mesh built. Elastic re-inits "
    "re-validate the degree against the surviving world.")
SPEC_LEAVES = _registry.gauge(
    "hvd_spec_leaves",
    "Parameter leaves the most recently classified per-leaf sharding "
    "spec assigned to each exchange family (kind = dense | expert | "
    "model): dense leaves reduce over every mesh axis, expert/model "
    "leaves stay sharded over their own axis and reduce over the rest.",
    labelnames=("kind",))

# Expert-parallel MoE (models/moe.py, optimizers.py expert_keys=,
# ops/collectives.py alltoall_chunked)
MOE_ROUTED_TOKENS = _registry.counter(
    "hvd_moe_routed_tokens_total",
    "Token-slot assignments the capacity router kept (landed in an "
    "expert's capacity buffer), summed over observed steps on this "
    "rank's shard.")
MOE_DROPPED_TOKENS = _registry.counter(
    "hvd_moe_dropped_tokens_total",
    "Token-slot assignments lost to expert capacity overflow (the "
    "residual path carries the token instead); a high ratio against "
    "hvd_moe_routed_tokens_total means capacity_factor is too low "
    "(docs/troubleshooting.md \"my MoE step drops too many tokens\").")
MOE_LOAD_BALANCE_LOSS = _registry.gauge(
    "hvd_moe_load_balance_loss",
    "Most recent Switch load-balancing aux loss (E * sum over experts "
    "of routed-fraction x mean router prob); ~top_k under uniform "
    "routing, growing as the router collapses onto few experts.")
MOE_CHUNKS = _registry.gauge(
    "hvd_moe_chunks",
    "Capacity slices the MoE dispatch/combine alltoall is pipelined "
    "into (HOROVOD_MOE_CHUNKS after the largest-divisor fallback); 1 = "
    "unchunked.")
MOE_ALLTOALL_HIDDEN_FRAC = _registry.gauge(
    "hvd_moe_alltoall_hidden_frac",
    "Fraction of dispatch/combine alltoall device time overlapped with "
    "expert FFN compute in the most recent trace capture (hvd_dispatch/"
    "hvd_combine vs hvd_expert scopes) — the chunked-pipeline win the "
    "CI moe-smoke gate asserts >= 0.3.")
EXCHANGE_HIDDEN_FRAC = _registry.gauge(
    "hvd_exchange_hidden_frac",
    "Fraction of gradient-exchange device time overlapped with forward/"
    "backward/optimizer compute in the most recent trace capture "
    "(hvd_exchange intervals vs the compute-phase union) — the bucketed "
    "backward/exchange overlap win (HOROVOD_EXCHANGE_BUCKETS) the CI "
    "overlap-smoke gate asserts >= 0.3.")

# Flight recorder + hang diagnosis (diag/)
DIAG_EVENTS = _registry.gauge(
    "hvd_diag_events_total",
    "Lifecycle events recorded by the flight recorder since install "
    "(the ring holds the most recent HOROVOD_FLIGHT_BUFFER of them).")
DIAG_DUMPS = _registry.counter(
    "hvd_diag_dumps_total",
    "Durable flight-recorder dumps written (stall, abort, or manual).")
DIAG_STALLS = _registry.counter(
    "hvd_diag_stalls_detected_total",
    "Collectives the hang watchdog found in-flight past "
    "HOROVOD_STALL_TIMEOUT_SECONDS.")
DIAG_DESYNC_MISSING = _registry.gauge(
    "hvd_diag_desync_missing_ranks",
    "Participants missing from the most recent stalled collective "
    "(set by process 0's desync report; 0 = no live desync).")
DIAG_PHASE_SECONDS = _registry.gauge(
    "hvd_diag_phase_seconds",
    "Cumulative per-phase attribution from the flight recorder's ring "
    "(wire / readback / input; the critical-path report's raw data).",
    labelnames=("phase",))

# Phase tracing + perf sentry (diag/xla_trace.py, diag/sentry.py)
XLA_TRACE_CAPTURES = _registry.counter(
    "hvd_xla_trace_captures_total",
    "Device-trace capture windows completed by hvd.trace_steps / "
    "HOROVOD_XPROF_STEPS (each writes a parsed xla-trace-meta.json "
    "under HOROVOD_DIAG_DIR).")
XLA_PHASE_SECONDS = _registry.gauge(
    "hvd_xla_phase_seconds",
    "Per-phase device seconds from the most recent trace capture "
    "(phase = forward | backward | exchange | optimizer | guard | "
    "dispatch | expert | combine | other — the last three are the MoE "
    "sub-phases: dispatch/combine alltoall wire time and expert FFN "
    "compute), summed over the window across device lanes.",
    labelnames=("phase",))
PERF_REGRESSIONS = _registry.counter(
    "hvd_perf_regressions_total",
    "Step-time or MFU regressions flagged by the perf sentry "
    "(HOROVOD_PERF_SENTRY=1) against the per-signature EMA baseline, "
    "by kind (step_time | mfu).", labelnames=("kind",))


def record_moe_step(routed, dropped, load_balance_loss, chunks):
    """Host-side per-step MoE accounting (bench loops / callbacks):
    feed the hvd_moe_* families from a ``moe_layer(...,
    with_stats=True)`` stats dict's fetched values."""
    MOE_ROUTED_TOKENS.inc(float(routed))
    MOE_DROPPED_TOKENS.inc(float(dropped))
    MOE_LOAD_BALANCE_LOSS.set(float(load_balance_loss))
    MOE_CHUNKS.set(int(chunks))


# ------------------------------------------------------------- rendering

def render_prometheus(snap):
    """Render a snapshot in the Prometheus text exposition format."""
    lines = []
    for name, fam in snap.items():
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for key, v in fam["values"].items():
            if isinstance(v, dict):  # histogram
                for bound, cum in v["buckets"].items():
                    sep = "," if key else ""
                    lines.append(
                        f'{name}_bucket{{{key}{sep}le="{bound}"}} {cum}')
                suffix = f"{{{key}}}" if key else ""
                lines.append(f"{name}_sum{suffix} {v['sum']}")
                lines.append(f"{name}_count{suffix} {v['count']}")
            else:
                suffix = f"{{{key}}}" if key else ""
                lines.append(f"{name}{suffix} {v}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- exporters

class MetricsExporters:
    """Export sinks + the low-rate background thread driving them.

    Sinks (all optional, per config):
    - ``metrics_dir``: ``metrics-<pid>.jsonl`` (one snapshot per line) and
      ``metrics-<pid>.prom`` (atomic-rename textfile, node-exporter
      textfile-collector convention);
    - ``metrics_port >= 0``: HTTP scrape endpoint serving ``/metrics``
      (port 0 binds an ephemeral port, exposed as ``http_port``).

    The JAX package's third sink, counter events spliced into the live
    timeline, waits for the timeline (ROADMAP.md, Queue 1 item 10):
    ``timeline`` must be None.

    ``close()`` performs one final export (so short jobs always land a
    snapshot), then stops the thread and the HTTP server. Everything is
    daemonized and join-bounded: shutdown can never hang on an
    exporter.
    """

    def __init__(self, config, timeline=None, process_index=0):
        if timeline is not None:
            raise NotImplementedError(
                "the metrics exporters' timeline sink needs the timeline "
                "(ROADMAP.md, Queue 1 item 10), which is not ported yet")
        self._interval = max(float(config.metrics_interval), 0.1)
        self._stop = threading.Event()
        self._lock = threading.Lock()  # serializes ticks vs close
        self._thread = None
        self._server = None
        self._server_thread = None
        self._jsonl = None
        self._prom_path = None
        self.http_port = None

        if config.metrics_dir:
            os.makedirs(config.metrics_dir, exist_ok=True)
            self._jsonl = open(
                os.path.join(config.metrics_dir,
                             f"metrics-{process_index}.jsonl"), "a")
            self._prom_path = os.path.join(
                config.metrics_dir, f"metrics-{process_index}.prom")
        if config.metrics_port is not None and config.metrics_port >= 0:
            self._start_http(config.metrics_port,
                             getattr(config, "metrics_bind", "127.0.0.1"))
        if self._jsonl or self._prom_path:
            self._thread = threading.Thread(
                target=self._loop, name="hvd-tpu-metrics", daemon=True)
            self._thread.start()

    @property
    def active(self):
        return bool(self._thread or self._server)

    def _start_http(self, port, bind="127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_GET(handler):  # noqa: N805 — handler self
                if handler.path.split("?")[0] not in ("/", "/metrics"):
                    handler.send_error(404)
                    return
                body = render_prometheus(_registry.snapshot()).encode()
                handler.send_response(200)
                handler.send_header("Content-Type",
                                    "text/plain; version=0.0.4")
                handler.send_header("Content-Length", str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)

            def log_message(handler, *a):  # noqa: N805 — silence stderr
                pass

        try:
            self._server = ThreadingHTTPServer((bind, port), Handler)
        except OSError as e:
            _logger.warning("metrics HTTP endpoint on %s:%d unavailable: "
                            "%s", bind, port, e)
            return
        self._server.daemon_threads = True
        self.http_port = self._server.server_address[1]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, name="hvd-tpu-metrics-http",
            daemon=True)
        self._server_thread.start()
        _logger.info("metrics scrape endpoint on :%d/metrics",
                     self.http_port)

    def _loop(self):
        while not self._stop.wait(self._interval):
            self.tick()

    def tick(self):
        """One export round over every configured sink (best-effort)."""
        snap = _registry.snapshot()
        with self._lock:
            if self._jsonl is not None and not self._jsonl.closed:
                try:
                    self._jsonl.write(json.dumps(
                        {"ts": time.time(),
                         "metrics": {n: f["values"]
                                     for n, f in snap.items()}}) + "\n")
                    self._jsonl.flush()
                except OSError as e:
                    _logger.warning("metrics JSONL write failed: %s", e)
            if self._prom_path is not None:
                try:
                    tmp = self._prom_path + ".tmp"
                    with open(tmp, "w") as f:
                        f.write(render_prometheus(snap))
                    os.replace(tmp, self._prom_path)
                except OSError as e:
                    _logger.warning("metrics textfile write failed: %s", e)

    def close(self):
        """Final export, then stop every thread/server. Idempotent."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._jsonl or self._prom_path:
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a last export is best-effort
                _logger.debug("final metrics export failed", exc_info=True)
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            if self._server_thread is not None:
                self._server_thread.join(timeout=5)
                self._server_thread = None


def start_exporters(config, timeline=None, process_index=0):
    """Build exporters for the session, or None when nothing is configured
    (no metrics dir or port) — the common test path keeps zero extra
    threads. The constructor's sink-enable logic is the single source of
    truth; an exporter with no active sinks is simply discarded."""
    exp = MetricsExporters(config, timeline=timeline,
                           process_index=process_index)
    if not exp.active:
        exp.close()
        return None
    return exp
