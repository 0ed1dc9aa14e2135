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
``device="cpu"``.

Rank model. In the JAX package a rank is a mesh position, and one process
can own eight of them (all of its host's chips). Here a rank is one
process with one card, as in the reference Horovod and in
``torch.distributed``: ``size()`` counts processes, ``rank()`` is this
process's place among them, and ``local_rank()`` picks its card.

Knobs that would start subsystems the port does not have yet (the
timeline, the guard, autotune, the metrics exporters) make ``init()``
raise rather than run without them.

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
    ("metrics_dir", "HOROVOD_METRICS_DIR", "the metrics exporters "
     "(ROADMAP.md, Queue 1 item 16)"),
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

    def graph_pool(self):
        """The CUDA graph memory pool this session's captures share."""
        with self._lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            return self._pool

    def __len__(self):
        return len(self._programs)

    def clear(self):
        with self._lock:
            self._programs.clear()
            self._pool = None


class _State:
    def __init__(self):
        self.initialized = False
        self.shutdown = False
        self.config = None
        self.device = None
        self.stats = None
        self.programs = None
        self.store = None
        self.mesh = None
        self.rank = 0
        self.size = 0
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        self.lock = threading.RLock()


_state = _State()
_logger = get_logger()


def _refuse_missing_subsystems(cfg):
    for attr, knob, what in _MISSING:
        if getattr(cfg, attr):
            raise NotImplementedError(
                f"{knob} is set, but {what} is not ported yet")
    if cfg.metrics_port >= 0:
        raise NotImplementedError(
            "HOROVOD_METRICS_PORT is set, but the metrics exporters "
            "(ROADMAP.md, Queue 1 item 16) are not ported yet")


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

        store, rank, size = _join_group()
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=store, rank=rank, world_size=size)

        from . import metrics
        from .stats import CollectiveStats, register_metrics
        _state.config = cfg
        _state.device = device
        _state.store = store
        _state.mesh = None
        _state.rank, _state.size = rank, size
        _state.local_rank = local_rank
        _state.local_size = _env_int("HOROVOD_TPU_LOCAL_SIZE", 1)
        _state.cross_rank = _env_int("HOROVOD_TPU_CROSS_RANK", rank)
        _state.cross_size = _env_int("HOROVOD_TPU_CROSS_SIZE", size)
        _state.stats = CollectiveStats()
        _state.programs = ProgramCache()
        register_metrics(_state.stats)
        metrics.RUNTIME_INITS.inc()
        metrics.RUNTIME_UP.set(1)
        metrics.RUNTIME_RANKS.set(size)
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
        metrics.RUNTIME_SHUTDOWNS.inc()
        metrics.RUNTIME_UP.set(0)
        if _state.rank == 0 and not _state.config.profiler_disable:
            try:
                _state.stats.write_to_file(_state.config.profiler_path)
            except OSError as e:
                _logger.warning("could not write profiler dump: %s", e)
        metrics.registry().remove_collect_hook("collective_stats")
        # The programs go first: a captured graph holds the collectives
        # of the group destroyed next.
        _state.programs.clear()
        dist.destroy_process_group()
        _state.store = None
        _state.mesh = None
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
