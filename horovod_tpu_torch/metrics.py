"""Process-wide metrics registry: labeled counters, gauges, histograms.

Counterpart of horovod_tpu/metrics.py, carrying the registry core with
its collect hooks, the serving families (``hvd_serve_*``, program
caches included), the compiled hot loop's cache and fallback families
(``hvd_step_*``), the runtime lifecycle families, the per-collective
mirror of stats.py, the ZeRO and staged-exchange families
(``hvd_zero_*``, ``hvd_wire_stage_*``, ``hvd_spec_leaves``), the
model-parallel degree (``hvd_model_parallel``) and the expert-parallel
MoE families (``hvd_moe_*``, fed by
:func:`record_moe_step`), under the JAX package's names and help texts.
``hvd_moe_alltoall_hidden_frac`` and ``hvd_wire_stage_seconds`` are
registered and left unset: they read a phase trace (item 16). The
exporters (JSONL, Prometheus, timeline counters) come with the
observability slice (ROADMAP.md, Queue 1 item 16).
"""

import threading

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
    return _registry.snapshot()


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

# Runtime lifecycle (runtime.py)
RUNTIME_INITS = _registry.counter(
    "hvd_init_total", "hvd.init() calls completed.")
RUNTIME_SHUTDOWNS = _registry.counter(
    "hvd_shutdown_total", "hvd.shutdown() calls completed.")
RUNTIME_UP = _registry.gauge(
    "hvd_up", "1 while the runtime is initialized, else 0.")
RUNTIME_RANKS = _registry.gauge(
    "hvd_ranks", "Total ranks (chips) in the current job.")

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


def record_moe_step(routed, dropped, load_balance_loss, chunks):
    """Host-side per-step MoE accounting (bench loops / callbacks):
    feed the hvd_moe_* families from a ``moe_layer(...,
    with_stats=True)`` stats dict's fetched values."""
    MOE_ROUTED_TOKENS.inc(float(routed))
    MOE_DROPPED_TOKENS.inc(float(dropped))
    MOE_LOAD_BALANCE_LOSS.set(float(load_balance_loss))
    MOE_CHUNKS.set(int(chunks))
