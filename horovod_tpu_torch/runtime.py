"""Process-wide runtime state: init/shutdown and rank topology.

Counterpart of horovod_tpu/runtime.py. ``init()`` builds the
``torch.distributed`` process group every collective of the port runs
on:

- launched by the JAX package's launcher (``HOROVOD_TPU_COORDINATOR``,
  ``HOROVOD_TPU_NUM_PROCESSES``, ``HOROVOD_TPU_PROCESS_ID``,
  ``HOROVOD_TPU_LOCAL_RANK``, ``HOROVOD_TPU_LOCAL_SIZE``), each process
  joins a ``TCPStore`` at the coordinator address, which process 0
  hosts. The store outlives the session: a later ``init()`` in the
  same process joins the same store (the JAX package keeps one
  process-0-hosted KV service for all sessions the same way,
  utils/compat.py), and each session's process group keys its
  rendezvous under a prefix of its own, ``hvd/<session>/pg/``. A store
  that closed and came back at one address across a re-init could be
  reached by a peer as it closed (``Broken pipe``);
- without them, the process forms a one-rank group on an in-memory
  ``HashStore``, and nothing listens on a network port.

The backend is NCCL on ``device="cuda"`` (the default) and gloo on
``device="cpu"``. A process that has already joined a default process
group (``torch.distributed.init_process_group``) keeps it: ``init()``
takes its backend, rank and size, and ``shutdown()`` leaves it to its
owner. That is how two ranks share one card, over gloo, where NCCL
refuses them. Elastic recovery replaces such a group, which has lost a
member, by the survivors' own, of the same backend.

Rank model. In the JAX package a rank is a mesh position, and one process
can own eight of them (all of its host's chips). Here a rank is one
process with one card, as in the reference Horovod and in
``torch.distributed``: ``size()`` counts processes, ``rank()`` is this
process's place among them, and ``local_rank()`` picks its card.

``init()`` builds the eager engine (ops/engine.py) that the top-level
``allreduce``/``allgather``/``broadcast``/``alltoall`` and their async
forms go through, with the session's native collective stats and, under
``HOROVOD_TIMELINE``, the timeline; ``shutdown()`` drains the engine,
then rank 0 writes ``profiler.txt`` (and ``profiler.csv`` under
``HOROVOD_WIRE_PROFILE``) and the timeline is closed, the other ranks'
events spliced into rank 0's file. With several ranks the engine's
coordinator keys its traffic under ``hvd/<session>/coord`` in the
session's store.

``HOROVOD_AUTOTUNE``, whose subsystem the port does not have yet, makes
``init()`` raise rather than run without it. ``init()`` installs the
step-integrity guard and its chaos injector (guard/; ``HOROVOD_GUARD``,
``HOROVOD_GUARD_INJECT``) before the engine; under ``HOROVOD_ELASTIC``
the process group it builds times a collective out after
``HOROVOD_ELASTIC_TIMEOUT_SECONDS`` (a dead peer then fails the
collective as :class:`~horovod_tpu_torch.exceptions.WorkerLostError`
instead of hanging for torch's default 30 minutes), and the engine's
ticker publishes liveness beacons.

``init(comm=[world ranks])`` runs the job on a subset of the launched
processes, renumbered 0..n-1 in the list's order: each member joins a
new default group over the session's store, under the session's own
prefix. This is how elastic recovery re-inits over the survivors
(elastic/runner.py): the dead process never joins, and the store, hosted
by process 0, outlives the old group (its loss ends the job, as in the
reference).

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
one memory pool), the engine's step-program tier
(``EagerEngine.step_program``). ``shutdown()`` drops it and the next
``init()`` starts an empty one, as an elastic re-init over a new
membership cold-starts the JAX engine's step-program tier.
"""

import atexit
import datetime
import os
import threading
from collections import OrderedDict

import torch
import torch.distributed as dist

from . import config as config_mod
from .exceptions import HorovodError, NotInitializedError, ShutDownError
from .utils.devices import resolve_device
from .utils.logging import get_logger

AXIS = "hvd"  # global mesh axis name for the data-parallel collective dimension

# What init() refuses, with the ROADMAP.md item that brings it: nothing
# at present (every knob of the config is honoured).
_MISSING = ()


class ProgramCache:
    """One session's step programs, keyed by signature, LRU-bounded,
    with hit and miss counts: the eager engine's step-program tier
    (``EagerEngine.step_program``; the JAX engine keeps it in a
    ``WireProgramCache``). On a card every program it builds captures into
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
        graph uses any more. It captures in ``thread_local`` mode, as
        the programs do: another thread's CUDA calls (the input
        pipeline's producer pinning and copying a batch) must not
        invalidate it."""
        with self._lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._anchor = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self._anchor, pool=self._pool,
                                      capture_error_mode="thread_local"):
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
        self.engine = None
        self.autotuner = None
        self.timeline = None
        self.owns_group = False
        self.backend = None
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
        self.world_rank = 0
        self.members = [0]
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


def _install_diagnostics(cfg, rank, size, store, timeline=None):
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
                                                       timeline=timeline,
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


# (host, port, size, rank) -> TCPStore: one store per coordinator
# address for the process's life, shared by every session.
_stores = {}


def _join_group():
    """(store, rank, size) of this process's group: its launcher rank
    and the launched world. A TCPStore is made once per coordinator
    address and kept for the process's life, so process 0's server
    outlives every session (module docstring)."""
    coord = os.environ.get("HOROVOD_TPU_COORDINATOR")  # hvdlint: disable=HVD003 -- launcher-worker protocol var set by run/, not a knob
    if not coord:
        return dist.HashStore(), 0, 1
    size = int(os.environ["HOROVOD_TPU_NUM_PROCESSES"])  # hvdlint: disable=HVD003 -- launcher-worker protocol var
    rank = int(os.environ["HOROVOD_TPU_PROCESS_ID"])  # hvdlint: disable=HVD003 -- launcher-worker protocol var
    host, port = coord.rsplit(":", 1)
    key = (host, int(port), size, rank)
    store = _stores.get(key)
    if store is None:
        store = _stores[key] = dist.TCPStore(
            host, int(port), size, is_master=rank == 0,
            timeout=datetime.timedelta(seconds=300))
    return store, rank, size


def job_store():
    """The job's key-value store, for the process's life: process 0's
    TCPStore at the coordinator address, or one in-memory store when the
    process runs alone. Elastic rendezvous runs on it between sessions."""
    if os.environ.get("HOROVOD_TPU_COORDINATOR"):  # hvdlint: disable=HVD003 -- launcher-worker protocol var set by run/, not a knob
        return _join_group()[0]
    store = _stores.get("local")
    if store is None:
        store = _stores["local"] = dist.HashStore()
    return store


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


def _check_comm(comm, world):
    """The list of world ranks ``comm`` names, checked as the JAX
    package checks it."""
    if not (isinstance(comm, (list, tuple, range))
            and all(isinstance(r, int) and not isinstance(r, bool)
                    for r in comm)):
        raise ValueError(
            "horovod_tpu_torch has no MPI: init(comm=...) takes a list of "
            "world ranks, e.g. comm=[0, 2, 5] — not an MPI communicator "
            "object.")
    ranks = [int(r) for r in comm]
    if not ranks:
        raise ValueError("comm names no rank")
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"comm has duplicate ranks: {ranks}")
    bad = [r for r in ranks if not 0 <= r < world]
    if bad:
        raise ValueError(f"comm ranks {bad} out of range [0, {world})")
    return ranks


def init(comm=None, *, device="cuda"):
    """Initialize the runtime: the process group, the rank topology and
    the collective stats. Idempotent; a second ``init()`` after
    ``shutdown()`` starts a new session.

    Args:
      comm: a rank-subset job (reference: ``hvd.init(comm=...)``,
        common/basics.py:29-55): a list of world ranks (the launched
        processes' ranks) to run on. The members renumber 0..n-1 in the
        list's order; a process outside the list takes no part and
        ``init()`` raises there (it must submit no collectives).
      device: ``"cuda"`` (default; NCCL, the card ``local_rank()``) or
        ``"cpu"`` (gloo, the plain versions of the kernels).
    """
    _init(comm, device)


def _init(comm, device, backend=None):
    """:func:`init`, the group's backend given: elastic recovery's
    re-init over the survivors (elastic/runner.py) builds their group
    with the dead session's backend, as a caller's own group (gloo on a
    card) had it. ``None``: NCCL on a card, gloo on the CPU."""
    with _state.lock:
        if _state.initialized and not _state.shutdown:
            return
        cfg = config_mod.Config.from_env()
        _refuse_missing_subsystems(cfg)
        from . import native
        native.get_lib()  # a failed build raises before any group exists
        local_rank = _env_int("HOROVOD_TPU_LOCAL_RANK", 0)
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", local_rank)
        device = resolve_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)

        session = _state.session + 1
        owns_group = not dist.is_initialized()
        world_rank = None
        if owns_group:
            store, rank, size = _join_group()
            world_rank = rank
            if comm is not None:
                ranks = _check_comm(comm, size)
                if rank not in ranks:
                    raise HorovodError(
                        f"this process (world rank {rank}) is not in "
                        f"comm={ranks}: it takes no part in the job and "
                        f"must submit no collectives")
                rank, size = ranks.index(rank), len(ranks)
                members = ranks
            else:
                members = list(range(size))
            kwargs = {}
            if cfg.elastic:
                kwargs["timeout"] = datetime.timedelta(
                    seconds=cfg.elastic_timeout_seconds)
            if backend is None:
                backend = "nccl" if device.type == "cuda" else "gloo"
            dist.init_process_group(
                backend,
                store=dist.PrefixStore(f"hvd/{session}/pg/", store),
                rank=rank, world_size=size, **kwargs)
        else:
            if comm is not None:
                raise ValueError(
                    "init(comm=...) builds its own group; this process "
                    "already joined a default process group")
            store, rank, size = None, dist.get_rank(), dist.get_world_size()
            members = list(range(size))

        from . import metrics
        from .stats import create_stats, register_metrics
        from .timeline import create_timeline
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
        _state.stats = create_stats()
        _state.programs = ProgramCache()
        _state.session = session
        # One trace for the job, written by rank 0: the other ranks
        # collect their events and ship them at shutdown
        # (reference: timeline.h:46-74).
        _state.timeline = create_timeline(
            cfg.timeline, enabled=bool(cfg.timeline),
            mark_cycles=cfg.timeline_mark_cycles,
            collect=size > 1 and rank != 0, multihost=size > 1)
        register_metrics(_state.stats)
        _state.backend = dist.get_backend()
        _state.world_rank = world_rank if world_rank is not None else rank
        _state.members = members
        # The flight recorder and the guard before the engine, which
        # caches diag.get(), guard.get() and guard.inject.get().
        _install_diagnostics(cfg, rank, size, store, _state.timeline)
        from . import guard
        guard.install(cfg, process_index=rank)
        from .ops.engine import EagerEngine
        _state.engine = EagerEngine(
            device, rank, size, cfg, _state.stats, _state.timeline,
            store=store, programs=_state.programs,
            local_size=cfg.dcn_local_size or _state.local_size,
            namespace=f"hvd/{session}/coord")
        _state.autotuner = None
        if cfg.autotune:
            # Only process 0 tunes; above one rank its changes ride the
            # coordinator's decision log, and every process applies them
            # at the same decision index (reference SyncParams,
            # parameter_manager.cc:223-262). The other processes apply
            # incoming autotune decisions in the engine and never tune.
            if size > 1 and rank != 0:
                _logger.info("autotune: process %d defers to process 0's "
                             "synced parameters", rank)
            else:
                from .autotune import ParameterManager
                _state.autotuner = ParameterManager(cfg)
                if size > 1:
                    _state.autotuner.sync_publish = \
                        _state.engine.publish_autotune
                _state.engine.autotuner = _state.autotuner
        _record_elastic_launch_stamps()
        metrics.RUNTIME_INITS.inc()
        metrics.RUNTIME_UP.set(1)
        metrics.RUNTIME_RANKS.set(size)
        metrics.ELASTIC_WORLD_SIZE.set(size)
        metrics.MODEL_PARALLEL.set(cfg.model_parallel if mdl_mesh else 1)
        _state.shutdown = False
        _state.initialized = True
        _logger.info("Started horovod_tpu_torch with %d ranks on %s (%s)",
                     size, device, dist.get_backend())
        atexit.register(_shutdown_atexit)


_elastic_stamps_recorded = False


def _record_elastic_launch_stamps():
    """Surface the elastic launcher's stamps in THIS worker's metrics
    registry (the launcher's own registry is never exported): how many
    times it respawned this slot (``HOROVOD_TPU_ELASTIC_RESTARTS``), and
    the direction of the gang resize that relaunched it
    (``HOROVOD_TPU_ELASTIC_RESIZED``; a grown world arrives only by gang
    restart, so the relaunched workers are the processes left to count
    it). Once per process: re-inits within one life (elastic recovery)
    are neither."""
    global _elastic_stamps_recorded
    if _elastic_stamps_recorded:
        return
    _elastic_stamps_recorded = True
    from . import metrics
    n = _env_int("HOROVOD_TPU_ELASTIC_RESTARTS", 0)
    if n > 0:
        metrics.ELASTIC_RESTARTS.inc(n)
    resized = os.environ.get("HOROVOD_TPU_ELASTIC_RESIZED", "")  # hvdlint: disable=HVD003 -- supervisor-worker protocol var, stamped per resize
    if resized in ("up", "down"):
        metrics.ELASTIC_RESIZES.labels(direction=resized).inc()


def _shutdown_atexit():
    try:
        if _state.initialized and not _state.shutdown:
            shutdown()
    except Exception:  # pragma: no cover - atexit best effort
        pass


def shutdown():
    """Shut down: the engine drains (its launched buckets complete, its
    queued handles fail with ShutDownError), rank 0 writes the
    per-collective counters and time histograms to ``profiler.txt``
    (``HOROVOD_PROFILER_PATH``; off with ``HOROVOD_PROFILER_DISABLE``)
    and, under ``HOROVOD_WIRE_PROFILE``, the wire profile to
    ``profiler.csv``; the timeline closes, and the process group is
    destroyed."""
    with _state.lock:
        if not _state.initialized or _state.shutdown:
            return
        from . import metrics
        from .diag import recorder as _recorder
        # Watchdog first: a beacon/stall scan must not race the teardown
        # it observes.
        _recorder.stop_watchdog()
        _state.engine.shutdown()
        # Lifecycle gauges flip BEFORE the exporters' final export, so a
        # cleanly shut-down job's textfile reports hvd_up 0.
        metrics.RUNTIME_SHUTDOWNS.inc()
        metrics.RUNTIME_UP.set(0)
        # The exporters close before the timeline: their final tick
        # splices the closing counter values in while it is open.
        if _state.metrics_exporters is not None:
            _state.metrics_exporters.close()
            _state.metrics_exporters = None
        _exchange_timeline()
        if _state.rank == 0 and not _state.config.profiler_disable:
            try:
                _state.stats.write_to_file(_state.config.profiler_path)
            except OSError as e:
                _logger.warning("could not write profiler dump: %s", e)
        if _state.rank == 0 and _state.config.wire_profile:
            try:
                metrics.dump_wire_profile(_state.config.wire_profile_path)
            except OSError as e:
                _logger.warning("could not write wire profile CSV: %s", e)
        _state.timeline.close()
        _uninstall_diagnostics()
        from . import guard
        guard.uninstall()
        metrics.registry().remove_collect_hook("collective_stats")
        # The programs go first: a captured graph holds the collectives
        # of the group destroyed next.
        _state.programs.clear()
        if _state.owns_group:
            dist.destroy_process_group()
        _state.store = None
        _state.engine = None
        _state.autotuner = None
        _state.timeline = None
        _state.mesh = None
        _state.expert_mesh = None
        _state.model_mesh = None
        _state.groups = {}
        _state.shutdown = True
        _state.initialized = False


def _exchange_timeline():
    """One trace for a job of several ranks: at shutdown the other ranks
    publish their collected events through the session's store, and
    rank 0 splices them into its file before closing it (reference:
    rank 0 writes one file covering every rank's tensors,
    timeline.h:46-74)."""
    import json as _json
    tl = _state.timeline
    coord = _state.engine.coordinator if _state.engine else None
    if not tl.enabled or coord is None:
        return
    ns = f"hvd/{_state.session}/tl"
    client = coord._client
    try:
        if tl.collected is not None:
            tl.drain()
            client.key_value_set_bytes(
                f"{ns}/{_state.rank}",
                _json.dumps({"epoch": tl.epoch,
                             "events": tl.collected}).encode(),
                allow_overwrite=True)
        elif _state.rank == 0:
            for p in range(1, _state.size):
                try:
                    blob = client.blocking_key_value_get_bytes(f"{ns}/{p}",
                                                               5000)
                except Exception:  # noqa: BLE001 — peer may have died
                    _logger.warning("timeline merge: no events from rank "
                                    "%d (exited without shutdown?)", p)
                    tl.merge_remote([], tl.epoch, label=f"p{p}")
                    continue
                payload = _json.loads(bytes(blob).decode())
                tl.merge_remote(payload["events"], payload["epoch"],
                                label=f"p{p}")
    except Exception:  # noqa: BLE001 — never block shutdown on a trace
        _logger.warning("timeline exchange failed", exc_info=True)


def departed_ranks():
    """Ranks of this session that announced a planned departure (the
    preemption grace writes ``bye/<rank>`` through the coordinator),
    sorted; empty at one rank or when the store cannot be read."""
    engine = _state.engine
    coord = engine.coordinator if engine is not None else None
    if coord is None:
        return []
    try:
        return coord.departed()
    except Exception:  # noqa: BLE001 — the store may be gone with rank 0
        return []


def world_rank():
    """This process's rank among the launched processes (the rank an
    ``init(comm=...)`` list names); ``rank()`` is its place in the
    session."""
    _check_init()
    return _state.world_rank


def members():
    """The world ranks of this session's processes, in rank order."""
    _check_init()
    return list(_state.members)


def engine():
    """The session's eager engine (ops/engine.py)."""
    return live_state().engine


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


def mpi_threads_supported():
    """The reference's ``hvd.mpi_threads_supported()``: there is no MPI,
    and the eager engine takes submissions from any thread, which is
    what callers probe for; True once initialized."""
    _check_init()
    return True
