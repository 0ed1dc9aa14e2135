"""Process-wide runtime state: init/shutdown and rank topology.

Counterpart of horovod_tpu/runtime.py. ``init()`` builds the
``torch.distributed`` process group every collective of the port runs
on:

- launched by the JAX package's launcher (``HOROVOD_TPU_COORDINATOR``,
  ``HOROVOD_TPU_NUM_PROCESSES``, ``HOROVOD_TPU_PROCESS_ID``,
  ``HOROVOD_TPU_LOCAL_RANK``, ``HOROVOD_TPU_LOCAL_SIZE``), each process
  joins a ``TCPStore`` at the coordinator address, which process 0
  hosts;
- without them, the process forms a one-rank group on an in-memory
  ``HashStore``, and nothing listens on a network port.

The backend is NCCL on ``device="cuda"`` (the default) and gloo on
``device="cpu"``. A process that has already joined a default process
group (``torch.distributed.init_process_group``) keeps it: ``init()``
takes its backend, rank and size, and ``shutdown()`` leaves it to its
owner. That is how two ranks share one card, over gloo, where NCCL
refuses them.

Rank model. In the JAX package a rank is a mesh position, and one process
can own eight of them (all of its host's chips). Here a rank is one
process with one card, as in the reference Horovod and in
``torch.distributed``: ``size()`` counts processes, ``rank()`` is this
process's place among them, and ``local_rank()`` picks its card.

Knobs that would start subsystems the port does not have yet (the
timeline, the guard, autotune) make ``init()`` raise rather than run
without them.

``init()`` also installs the diagnostics (diag/): the flight recorder
(``HOROVOD_FLIGHT_BUFFER``), the phase tracer (``HOROVOD_XPROF_STEPS``),
the perf sentry (``HOROVOD_PERF_SENTRY``), the hang watchdog
(``HOROVOD_STALL_TIMEOUT_SECONDS``, its beacons through the session's
store under ``hvd/<session>``) and the metrics exporters
(``HOROVOD_METRICS_DIR`` / ``HOROVOD_METRICS_PORT``), with a collect
hook reading the card's memory (``torch.cuda.memory_stats``) into the
``hvd_device_*`` gauges; ``shutdown()`` takes them down again. Each is
off, and holds no thread or state, unless its knob asks for it.

With ``HOROVOD_EXPERT_PARALLEL`` above 1, ``init()`` also builds the
2-D (data, expert) mesh of expert-parallel MoE (:func:`expert_mesh`;
parallel/mesh.py), whose sub-groups every rank creates in the same
order; with ``HOROVOD_MODEL_PARALLEL`` above 1, the 3-D (data, expert,
model) mesh of tensor parallelism (:func:`model_mesh`), whose expert
axis is there at size 1 too. The ICI and DCN tiers of the staged exchange are built on first
use and kept for the session (:func:`cached_groups`).

Each session owns a :class:`ProgramCache`: the signature-keyed step
programs of ops/step_program.py (on a card, captured CUDA graphs sharing
one memory pool). ``shutdown()`` drops it and the next ``init()`` starts
an empty one, as an elastic re-init over a new membership cold-starts
the JAX engine's step-program tier.
"""

import atexit
import datetime
import os
import threading
from collections import OrderedDict

import torch
import torch.distributed as dist

from . import config as config_mod
from .exceptions import NotInitializedError, ShutDownError
from .utils.devices import resolve_device
from .utils.logging import get_logger

AXIS = "hvd"  # global mesh axis name for the data-parallel collective dimension

# What init() refuses, with the ROADMAP.md item that brings it.
_MISSING = (
    ("timeline", "HOROVOD_TIMELINE", "the timeline (ROADMAP.md, Queue 1 "
     "item 10)"),
    ("autotune", "HOROVOD_AUTOTUNE", "autotune (ROADMAP.md, Queue 1 item "
     "10)"),
    ("guard", "HOROVOD_GUARD", "the step-integrity guard (ROADMAP.md, "
     "Queue 1 item 15)"),
)


class ProgramCache:
    """One session's step programs, keyed by signature, LRU-bounded,
    with hit and miss counts: the counterpart of the JAX engine's
    step-program tier (``EagerEngine.step_program`` over a
    ``WireProgramCache``), whose engine is not ported yet (ROADMAP.md,
    Queue 1 item 10). On a card every program it builds captures into
    one CUDA graph memory pool (:meth:`graph_pool`): programs replay one
    at a time on one stream, so they may share what each frees."""

    def __init__(self, capacity=256):
        self.capacity = capacity
        self._programs = OrderedDict()
        self._lock = threading.RLock()
        self._pool = None
        self._anchor = None
        self.hits = 0
        self.misses = 0

    def get(self, signature, build):
        """``(program, was_hit)``: the program cached under
        ``signature``, or ``build()``'s, cached."""
        with self._lock:
            prog = self._programs.get(signature)
            if prog is not None:
                self._programs.move_to_end(signature)
                self.hits += 1
                return prog, True
            self.misses += 1
            prog = self._programs[signature] = build()
            while len(self._programs) > self.capacity:
                self._programs.popitem(last=False)
            return prog, False

    def discard(self, signature):
        """Drop the program cached under ``signature``, if any: a step
        or an engine that dies takes its programs (and what their
        captures hold in the pool) with it."""
        with self._lock:
            self._programs.pop(signature, None)

    def graph_pool(self):
        """The CUDA graph memory pool this session's captures share. A
        graph of one fill, held for the session, keeps the pool in use:
        the graphs that share it may all leave with the steps that
        dropped them, and the allocator refuses a capture into a pool no
        graph uses any more."""
        with self._lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._anchor = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self._anchor, pool=self._pool):
                    torch.zeros((), device="cuda")
            return self._pool

    def __len__(self):
        return len(self._programs)

    def clear(self):
        with self._lock:
            self._programs.clear()
            self._pool = self._anchor = None


class _State:
    def __init__(self):
        self.initialized = False
        self.shutdown = False
        self.config = None
        self.device = None
        self.stats = None
        self.programs = None
        self.store = None
        self.owns_group = False
        self.mesh = None
        self.expert_mesh = None
        self.model_mesh = None
        self.groups = {}
        self.rank = 0
        self.size = 0
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        self.session = 0
        self.metrics_exporters = None
        self.lock = threading.RLock()


_state = _State()
_logger = get_logger()


def _refuse_missing_subsystems(cfg):
    for attr, knob, what in _MISSING:
        if getattr(cfg, attr):
            raise NotImplementedError(
                f"{knob} is set, but {what} is not ported yet")


_mem_sampled_t = float("-inf")


def _collect_device_memory():
    """Low-rate device-memory gauges from ``torch.cuda.memory_stats``
    (the CPU publishes nothing). Runs as a metrics collect hook, so the
    exporter thread's tick cadence is the sampling clock; throttled to
    the configured interval."""
    global _mem_sampled_t
    import time as _time

    from . import metrics
    dev, cfg = _state.device, _state.config
    if dev is None or dev.type != "cuda":
        return
    interval = cfg.metrics_interval if cfg is not None else 10.0
    now = _time.perf_counter()
    if now - _mem_sampled_t < interval:
        return
    _mem_sampled_t = now
    st = torch.cuda.memory_stats(dev)
    label = str(dev.index)
    metrics.DEVICE_BYTES_IN_USE.labels(device=label).set(
        st.get("allocated_bytes.all.current", 0))
    metrics.DEVICE_PEAK_BYTES.labels(device=label).set(
        st.get("allocated_bytes.all.peak", 0))
    metrics.DEVICE_BYTES_LIMIT.labels(device=label).set(
        torch.cuda.get_device_properties(dev).total_memory)


def _install_diagnostics(cfg, rank, size, store):
    """The flight recorder, the phase tracer, the perf sentry, the hang
    watchdog and the metrics exporters of a new session (each None
    unless its knob opts in), as the JAX package's ``init()`` installs
    them."""
    from . import diag, metrics
    from .diag import sentry as _sentry
    from .diag import xla_trace as _xla_trace
    diag.install(cfg, rank=rank, process_index=rank)
    _xla_trace.install(cfg, rank=rank, size=size)
    _sentry.install(cfg, rank=rank)
    if store is None and dist.is_initialized():
        store = dist.distributed_c10d._get_default_store()
    diag.start_watchdog(cfg, store=store, rank=rank, size=size,
                        namespace=f"hvd/{_state.session}")
    metrics.registry().set_collect_hook("device_memory",
                                        _collect_device_memory)
    _state.metrics_exporters = metrics.start_exporters(cfg,
                                                       process_index=rank)


def _uninstall_diagnostics():
    """Take the session's diagnostics down after its watchdog: the
    exporters after their final export, the tracer (stopping a capture
    still running), the sentry (persisting its baselines) and the
    recorder."""
    from . import diag, metrics
    from .diag import sentry as _sentry
    from .diag import xla_trace as _xla_trace
    if _state.metrics_exporters is not None:
        _state.metrics_exporters.close()
        _state.metrics_exporters = None
    metrics.registry().remove_collect_hook("device_memory")
    _xla_trace.uninstall()
    _sentry.uninstall()
    diag.uninstall()


def _env_int(name, default):
    v = os.environ.get(name, "")
    return int(v) if v else default


def _join_group():
    """(store, rank, size) of this process's group; the store is kept so
    a TCPStore server lives as long as the session."""
    coord = os.environ.get("HOROVOD_TPU_COORDINATOR")
    if not coord:
        return dist.HashStore(), 0, 1
    size = int(os.environ["HOROVOD_TPU_NUM_PROCESSES"])
    rank = int(os.environ["HOROVOD_TPU_PROCESS_ID"])
    host, port = coord.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), size, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=300))
    return store, rank, size


def _meshes(cfg, device_type, size):
    """The expert and model meshes the config asks for (None where it
    does not): the 2-D (data, expert) one at ``expert_parallel > 1``,
    the 3-D (data, expert, model) one at ``model_parallel > 1``, whose
    expert axis is there at size 1 too, so a sharding spec can always
    name all three axes."""
    from .parallel.mesh import expert_data_mesh, model_expert_data_mesh
    exp_mesh = mdl_mesh = None
    if cfg.expert_parallel > 1:
        exp_mesh = expert_data_mesh(device_type, size,
                                    expert_parallel=cfg.expert_parallel,
                                    data_axis=AXIS, expert_axis="ep")
    if cfg.model_parallel > 1:
        mdl_mesh = model_expert_data_mesh(
            device_type, size, expert_parallel=cfg.expert_parallel,
            model_parallel=cfg.model_parallel, data_axis=AXIS,
            expert_axis="ep", model_axis="model")
    return exp_mesh, mdl_mesh


def init(comm=None, *, device="cuda"):
    """Initialize the runtime: the process group, the rank topology and
    the collective stats. Idempotent; a second ``init()`` after
    ``shutdown()`` starts a new session.

    Args:
      comm: the JAX package's rank-subset job; not ported yet.
      device: ``"cuda"`` (default; NCCL, the card ``local_rank()``) or
        ``"cpu"`` (gloo, the plain versions of the kernels).
    """
    with _state.lock:
        if _state.initialized and not _state.shutdown:
            return
        if comm is not None:
            raise NotImplementedError(
                "init(comm=...) is not ported yet (ROADMAP.md, Queue 1 "
                "item 2)")
        cfg = config_mod.Config.from_env()
        _refuse_missing_subsystems(cfg)
        local_rank = _env_int("HOROVOD_TPU_LOCAL_RANK", 0)
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", local_rank)
        device = resolve_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)

        owns_group = not dist.is_initialized()
        if owns_group:
            store, rank, size = _join_group()
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo", store=store,
                rank=rank, world_size=size)
        else:
            store, rank, size = None, dist.get_rank(), dist.get_world_size()

        from . import metrics
        from .stats import CollectiveStats, register_metrics
        try:
            exp_mesh, mdl_mesh = _meshes(cfg, device.type, size)
        except Exception:
            # a degree the world does not divide: leave no group behind
            if owns_group:
                dist.destroy_process_group()
            raise
        _state.config = cfg
        _state.device = device
        _state.store = store
        _state.owns_group = owns_group
        _state.mesh = None
        _state.expert_mesh = exp_mesh
        _state.model_mesh = mdl_mesh
        _state.groups = {}
        _state.rank, _state.size = rank, size
        _state.local_rank = local_rank
        _state.local_size = _env_int("HOROVOD_TPU_LOCAL_SIZE", 1)
        _state.cross_rank = _env_int("HOROVOD_TPU_CROSS_RANK", rank)
        _state.cross_size = _env_int("HOROVOD_TPU_CROSS_SIZE", size)
        _state.stats = CollectiveStats()
        _state.programs = ProgramCache()
        _state.session += 1
        register_metrics(_state.stats)
        _install_diagnostics(cfg, rank, size, store)
        metrics.RUNTIME_INITS.inc()
        metrics.RUNTIME_UP.set(1)
        metrics.RUNTIME_RANKS.set(size)
        metrics.MODEL_PARALLEL.set(cfg.model_parallel if mdl_mesh else 1)
        _state.shutdown = False
        _state.initialized = True
        _logger.info("Started horovod_tpu_torch with %d ranks on %s (%s)",
                     size, device, dist.get_backend())
        atexit.register(_shutdown_atexit)


def _shutdown_atexit():
    try:
        if _state.initialized and not _state.shutdown:
            shutdown()
    except Exception:  # pragma: no cover - atexit best effort
        pass


def shutdown():
    """Shut down: rank 0 writes the per-collective counters and time
    histograms to ``profiler.txt`` (``HOROVOD_PROFILER_PATH``; off with
    ``HOROVOD_PROFILER_DISABLE``), then the process group is destroyed."""
    with _state.lock:
        if not _state.initialized or _state.shutdown:
            return
        from . import metrics
        from .diag import recorder as _recorder
        # Watchdog first: a beacon/stall scan must not race the teardown
        # it observes.
        _recorder.stop_watchdog()
        # Lifecycle gauges flip BEFORE the exporters' final export, so a
        # cleanly shut-down job's textfile reports hvd_up 0.
        metrics.RUNTIME_SHUTDOWNS.inc()
        metrics.RUNTIME_UP.set(0)
        if _state.rank == 0 and not _state.config.profiler_disable:
            try:
                _state.stats.write_to_file(_state.config.profiler_path)
            except OSError as e:
                _logger.warning("could not write profiler dump: %s", e)
        _uninstall_diagnostics()
        metrics.registry().remove_collect_hook("collective_stats")
        # The programs go first: a captured graph holds the collectives
        # of the group destroyed next.
        _state.programs.clear()
        if _state.owns_group:
            dist.destroy_process_group()
        _state.store = None
        _state.mesh = None
        _state.expert_mesh = None
        _state.model_mesh = None
        _state.groups = {}
        _state.shutdown = True
        _state.initialized = False


def is_initialized():
    return _state.initialized and not _state.shutdown


def _check_init():
    if not is_initialized():
        raise NotInitializedError()


def live_state():
    """The session's state for an operation: raises
    :class:`ShutDownError` after ``shutdown()`` and
    :class:`NotInitializedError` before any ``init()``."""
    if _state.shutdown:
        raise ShutDownError()
    _check_init()
    return _state


def device():
    """The card (or the CPU) this rank's collectives run on."""
    _check_init()
    return _state.device


def mesh():
    """The global 1-D ``DeviceMesh`` over every rank (axis ``hvd``),
    built on first use."""
    _check_init()
    if _state.mesh is None:
        from .parallel.mesh import data_parallel_mesh
        _state.mesh = data_parallel_mesh(_state.device.type, _state.size,
                                         axis_name=AXIS)
    return _state.mesh


def expert_mesh():
    """The 2-D (data, expert) ``DeviceMesh`` — axes ``("hvd", "ep")`` —
    built when ``HOROVOD_EXPERT_PARALLEL > 1``. Raises when expert
    parallelism was not configured at init."""
    _check_init()
    if _state.expert_mesh is None:
        from .exceptions import HorovodError
        raise HorovodError(
            "no expert mesh: set HOROVOD_EXPERT_PARALLEL (or "
            "Config.expert_parallel) to a degree > 1 dividing the world "
            "size before hvd.init()")
    return _state.expert_mesh


def model_mesh():
    """The 3-D (data, expert, model) ``DeviceMesh`` — axes
    ``("hvd", "ep", "model")`` — built when ``HOROVOD_MODEL_PARALLEL >
    1``; its expert axis is there at degree 1 too. Raises when model
    parallelism was not configured at init."""
    _check_init()
    if _state.model_mesh is None:
        from .exceptions import HorovodError
        raise HorovodError(
            "no model mesh: set HOROVOD_MODEL_PARALLEL (or "
            "Config.model_parallel) to a degree > 1 such that "
            "expert_parallel * model_parallel divides the world size "
            "before hvd.init()")
    return _state.model_mesh


def model_parallel_size():
    """Configured model-parallel degree (1 = no model mesh)."""
    _check_init()
    return (_state.model_mesh.size(2)
            if _state.model_mesh is not None else 1)


def cached_groups(key, build):
    """``build()``'s process groups, built once a session under ``key``.
    ``torch.distributed`` creates a group collectively, over the world,
    in the same order on every rank, so a caller builds every group of a
    layout at once (ops/collectives.py ``_stage_groups``: the ICI and DCN
    tiers of the staged exchange); the cache keeps them until
    ``shutdown()``, so a captured step finds them made and warmed."""
    st = live_state()
    with st.lock:
        if key not in st.groups:
            st.groups[key] = build()
        return st.groups[key]


def expert_parallel_size():
    """Configured expert-parallel degree (1 = no expert mesh)."""
    _check_init()
    return (_state.expert_mesh.size(1)
            if _state.expert_mesh is not None else 1)


def rank():
    """This process's rank. Reference: horovod_rank."""
    _check_init()
    return _state.rank


def size():
    """Total number of ranks (processes, one card each). Reference:
    horovod_size."""
    _check_init()
    return _state.size


def local_rank():
    """Rank within the host; picks this process's card. Reference:
    horovod_local_rank."""
    _check_init()
    return _state.local_rank


def local_size():
    """Ranks on this host. Reference: horovod_local_size."""
    _check_init()
    return _state.local_size


def cross_rank():
    """Host index (the reference's cross communicator rank)."""
    _check_init()
    return _state.cross_rank


def cross_size():
    """Number of hosts."""
    _check_init()
    return _state.cross_size
