"""Eager op-at-a-time collective engine: handles, negotiation, fusion.

Counterpart of horovod_tpu/ops/engine.py. Reference equivalent: the core
runtime's background-thread pipeline — ``EnqueueTensorAllreduce/
Allgather/Broadcast`` (operations.cc:2013-2135), the per-cycle
coordinator loop ``RunLoopOnce`` (operations.cc:1434-1843), rank-0
negotiation + ``ConstructResponse`` consistency checks
(operations.cc:191-527), tensor fusion ``FuseResponses``
(operations.cc:577-700), the ``ResponseCache`` steady-state bypass
(response_cache.{h,cc}), and stall detection ``CheckForStalledTensors``
(operations.cc:815-896).

What the engine keeps of the reference is its observable contract:

- the handle-based async API (``allreduce_async``/``poll``/
  ``synchronize``, torch/mpi_ops.py:54-438);
- name-keyed readiness: an op starts only when every rank submitted the
  name;
- duplicate-name rejection per rank (operations.cc:142-145, :2042);
- cross-rank dtype/op/shape/root mismatch errors with the reference's
  exact wording (negotiation.py), raised before any collective launches
  (a launch with mismatched counts would hang NCCL rather than fail);
- tensor fusion of small ops into one collective under
  ``HOROVOD_FUSION_THRESHOLD`` with dtype-grouped look-ahead
  (operations.cc:577-700; the native planner, csrc/fusion.cc), aligned
  to ``FUSION_BUFFER_ATOMIC_UNIT``;
- the response cache keyed by tensor metadata (native,
  csrc/response_cache.cc);
- stall warnings and shutdown with the reference's message format;
- the fork's padding experiment (``PADDING_ALGO=1`` rounds fused
  element counts up to a power of two, ops/mpi_operations.cc:24-63).

Rank model. A rank is a process. At ``size() == 1`` negotiation runs in
process; above it every cycle goes through the coordinator
(coordinator.py) over the session's store, whose decision log gives
every rank the same order of collectives, and only the thread applying
a decision launches them. ``enqueue(rank=r)`` accepts only this
process's rank.

Data plane. Each fused batch is one flat buffer per wire dtype on the
tensors' device, filled by copies, with one ``dist.all_reduce`` (NCCL on
a card, gloo on the CPU) — at every world size, one included, so the
collectives a job runs are the ones a one-card run shows. On a card the
engine runs on a stream of its own: every request records an event on
its producer's stream at ``enqueue``, and the engine's stream waits on
it before the copy reads the tensor; a result resolves with an event
that ``synchronize`` makes the caller's stream wait on, never with a
host copy. Results are views or copies of the fused buffer on the
input's device. A batch of one in-place request at or above the
threshold, unpadded, is reduced in place without the copy in and out.
The engine is never captured into a CUDA graph: the compiled step
(ops/step_program.py) keeps its own exchange.

One result path. Every collective completes in the overlap pipeline
(``HOROVOD_PIPELINE_DEPTH`` in flight, a completion thread waiting on
their ``Work``), fused buckets with ``PADDING_ALGO``'s exact sizes. The
JAX package's second path, ``to_host=False`` (results left on the
device, its buckets padded to a power of two so XLA compiles one
program per size class), has no counterpart: here every result stays
on the input's device, so the API's ``to_host`` flag changes nothing
(a known difference: ``profiler.txt``'s message sizes of such buckets
differ from the JAX package's).

Locking. Collectives launch under the engine lock, in the order the
cycle applies decisions, so every rank launches them in the same order;
no thread waits on a ``Work`` while holding the lock (under gloo the
wait blocks the host for the whole transfer). The hierarchical route is
the exception: its two-level sum runs synchronously at launch.
"""

import ctypes
import hashlib
import math
import threading
import time
from collections import OrderedDict, deque

import torch
import torch.distributed as dist
from torch.profiler import record_function

from .. import diag, guard, metrics
from .. import timeline as tl
from ..config import next_power_of_two
from ..diag import recorder as _recorder
from ..exceptions import (DuplicateNameError, HorovodError, HostsUpdatedError,
                          MismatchError, ShutDownError, StalledTensorError,
                          TransientCollectiveError, WorkerLostError)
from ..negotiation import (ALLGATHER, ALLREDUCE, ALLTOALL, BROADCAST,
                           RequestMeta, construct_response)
from ..stats import untraced
from ..utils.logging import get_logger
from .collectives import (hierarchical_allreduce, peer_error,
                          segment_health, unfuse_segments)

_logger = get_logger()

_OP_NAMES = {ALLREDUCE: "allreduce", ALLGATHER: "allgather",
             BROADCAST: "broadcast", ALLTOALL: "alltoall"}


def _dtype_name(dtype):
    """The reference's DataType_Name of a torch dtype ('float32', ...)."""
    return str(dtype).replace("torch.", "")


def _nbytes(t):
    return t.numel() * t.element_size()


class _InFlight:
    """A launched but not yet completed collective (the overlap
    pipeline's unit of work): a fused allreduce bucket, or one
    allgather, broadcast or alltoall. ``names`` and ``handles`` are what
    it resolves. Completion — waiting on ``work`` outside the engine
    lock, then ``finish(wait)`` under it with the engine's stream
    current, which builds the results and resolves the handles —
    happens on the completion thread, in ``synchronize()``/``poll()``,
    in a cycle's backpressure, or at drain."""

    __slots__ = ("names", "handles", "work", "finish", "activity",
                 "t_dispatch")

    def __init__(self, names, handles, work, finish, activity=True):
        self.names = names
        self.handles = handles
        self.work = work
        self.finish = finish
        self.activity = activity  # a timeline activity span is open
        self.t_dispatch = time.perf_counter()


class _Request:
    """One rank's submission for one named tensor (reference: Request,
    message.h:45-98)."""

    __slots__ = ("op", "rank", "name", "tensor", "average", "root_rank",
                 "compression", "handle", "prescale", "postscale", "seq",
                 "inplace", "ready", "_meta")

    def __init__(self, op, rank, name, tensor, handle, average=True,
                 root_rank=0, compression=None, prescale=None, postscale=None,
                 seq=0, inplace=False, ready=None):
        self.op = op
        self.rank = rank
        self.name = name
        self.tensor = tensor
        self.handle = handle
        self.average = average
        self.root_rank = root_rank
        self.compression = compression
        self.prescale = prescale
        self.postscale = postscale
        self.seq = seq
        self.inplace = inplace
        self.ready = ready        # CUDA event on the producer's stream
        self._meta = None

    def meta(self):
        # Cached: publish cycles re-read every pending request's metadata
        # (a request is immutable after enqueue).
        if self._meta is None:
            self._meta = RequestMeta(rank=self.rank, op=self.op,
                                     dtype=_dtype_name(self.tensor.dtype),
                                     shape=tuple(self.tensor.shape),
                                     root_rank=self.root_rank,
                                     average=bool(self.average))
        return self._meta


class _Entry:
    """A fully-negotiated named tensor ready for execution (reference:
    TensorTableEntry, common.h:177-195)."""

    __slots__ = ("name", "op", "requests", "dtype", "nbytes", "sizes")

    def __init__(self, name, op, requests):
        self.name = name
        self.op = op
        self.requests = requests  # rank -> _Request (this process's rank)
        self.dtype = requests[min(requests)].tensor.dtype
        self.nbytes = max(_nbytes(r.tensor) for r in requests.values())
        self.sizes = None  # allgather per-rank dim-0 sizes (negotiated)


class ResponseCache:
    """LRU cache of negotiated responses keyed by tensor metadata: the
    pure-Python mirror of csrc/response_cache.cc, constructed by tests
    (the engine uses :class:`NativeResponseCache`).

    Reference: ResponseCache (response_cache.h:44) — steady-state
    training loops submit identical metadata every step, so negotiation
    can be skipped. Capacity default 1024 (global_state.h:169).
    """

    def __init__(self, capacity):
        self.capacity = capacity
        self._cache = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(req):
        return (req.op, req.name, _dtype_name(req.tensor.dtype),
                tuple(req.tensor.shape), req.root_rank, bool(req.average))

    def lookup(self, req):
        if self.capacity <= 0:
            return False
        k = self.key(req)
        if k in self._cache:
            self._cache.move_to_end(k)
            self.hits += 1
            return True
        self.misses += 1
        return False

    def put(self, req):
        if self.capacity <= 0:
            return
        self._cache[self.key(req)] = True
        self._cache.move_to_end(self.key(req))
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)

    def invalidate_name(self, name):
        """Drop every entry for a name the stall detector flagged — a later
        resolution with different metadata must re-validate (reference:
        InvalidateStalledCachedTensors, operations.cc:899-913)."""
        for k in [k for k in self._cache if k[1] == name]:
            del self._cache[k]

    def clear(self):
        self._cache.clear()


class NativeResponseCache:
    """ctypes facade over csrc/response_cache.cc with the same contract as
    ResponseCache (the reference's LRU semantics live in C++)."""

    key = staticmethod(ResponseCache.key)

    def __init__(self, lib, capacity):
        self._lib = lib
        self.capacity = capacity
        self._h = lib.hvd_cache_new(int(capacity))
        # Shadow index for name-keyed invalidation, kept in LRU lockstep
        # with the native cache: recency bumps on BOTH put and lookup hit
        # (the native Lookup splices to the front, response_cache.cc), so
        # eviction order matches. Removing a key the native side already
        # evicted stays a no-op.
        self._key_names = OrderedDict()  # key repr -> name

    def lookup(self, req):
        k = repr(self.key(req))
        hit = bool(self._lib.hvd_cache_lookup(self._h, k.encode()))
        if hit and k in self._key_names:
            self._key_names.move_to_end(k)
        return hit

    def put(self, req):
        if self.capacity <= 0:
            return
        k = repr(self.key(req))
        self._key_names[k] = req.name
        self._key_names.move_to_end(k)
        while len(self._key_names) > self.capacity:
            self._key_names.popitem(last=False)
        self._lib.hvd_cache_put(self._h, k.encode())

    def invalidate_name(self, name):
        for k in [k for k, n in self._key_names.items() if n == name]:
            del self._key_names[k]
            self._lib.hvd_cache_remove(self._h, k.encode())

    def clear(self):
        for k in list(self._key_names):
            self._lib.hvd_cache_remove(self._h, k.encode())
        self._key_names.clear()

    @property
    def hits(self):
        return int(self._lib.hvd_cache_hits(self._h))

    @property
    def misses(self):
        return int(self._lib.hvd_cache_misses(self._h))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.hvd_cache_free(h)


def participants_digest(rank_count, backend):
    """Short stable digest of the participant set: part of every wire
    cache key, so a layout cached for one membership never serves
    another."""
    return hashlib.sha1(repr((int(rank_count), str(backend))).encode()) \
        .hexdigest()[:12]


class WireProgramCache:
    """Signature-keyed cache of the engine's wire layouts, LRU-bounded,
    with hit/miss accounting surfaced as ``hvd_engine_wire_cache_*``.

    In the JAX package each entry is a compiled XLA program, one per
    ``(op, wire dtype, padded rows, segments, participants)`` signature.
    Here a collective needs no program, and an entry is what such a
    program fixes: a bucket's segment layout (offsets, counts, padded
    length), keyed the same way. Steady-state training hits one entry
    per bucket; a growing miss count means bucket shapes churn.
    """

    def __init__(self, participants_digest, capacity=256):
        self.participants_digest = participants_digest
        self.capacity = capacity
        self._programs = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, signature, build):
        key = (self.participants_digest,) + tuple(signature)
        prog = self._programs.get(key)
        if prog is not None:
            self._programs.move_to_end(key)
            self.hits += 1
            return prog
        self.misses += 1
        prog = self._programs[key] = build()
        while len(self._programs) > self.capacity:
            self._programs.popitem(last=False)
        return prog

    def __len__(self):
        return len(self._programs)

    @property
    def hit_rate(self):
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def invalidate(self):
        self._programs.clear()


class _Watch:
    """What the hang watchdog (diag/recorder.py) watches for one
    submission: in flight from ``enqueue`` until its handle resolves,
    negotiation included — a rank waiting for a late peer is stalled
    inside the collective as the reference sees it."""

    __slots__ = ("name", "op", "t_dispatch", "_engine", "_handle")

    def __init__(self, engine, name, op, handle):
        self._engine, self._handle = engine, handle
        self.name, self.op = name, op
        self.t_dispatch = time.perf_counter()

    def in_flight(self):
        return isinstance(self._engine._handles.get(self._handle), str)  # hvdlint: disable=HVD002 -- GIL-atomic dict read from the watchdog thread


class EagerEngine:
    """Name-keyed negotiation, fusion and execution of eager collectives
    over the session's process group."""

    # Shared-state discipline: these fields are touched by the app
    # threads, the completion thread and the ticker, and every access
    # holds the engine lock (the Condition _cv shares it). Methods named
    # *_locked are caller-holds-the-lock by convention. Collectives
    # launch under the lock, in decision order (the ranks' launch order
    # is the decision log's); every wait on a Work — poll(),
    # synchronize(), a cycle's backpressure, the completion thread, the
    # drain — runs with the lock released (module docstring). On a card
    # that wait only orders streams.
    _GUARDED_BY = {
        "_inflight": "_lock",
        "_table": "_lock",
        "_first_seen": "_lock",
        "_stall_warned": "_lock",
        "_handles": "_lock",
        "_events": "_lock",
        "_next_handle": "_lock",
        "_pending_bytes": "_lock",
        "_next_seq": "_lock",
    }
    _LOCK_ALIASES = {"_cv": "_lock"}

    def __init__(self, device, rank, num_ranks, config, stats, timeline,
                 store=None, programs=None, local_size=1, namespace=None):
        self.device = torch.device(device)
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self.config = config
        self.stats = stats
        self.timeline = timeline
        self._cuda = self.device.type == "cuda"
        self._lock = threading.RLock()
        # Completion signaling shares the engine lock: waiters park here
        # and every handle resolution (cycle or completion thread)
        # notifies.
        self._cv = threading.Condition(self._lock)
        # _shutdown: no more submissions (this process's shutdown, or a
        # peer's echoed by the coordinator); _closed: shutdown() ran.
        self._shutdown = False
        self._closed = False
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        # Overlap pipeline state: launched buckets awaiting completion and
        # the completion thread that drains them.
        self._inflight = deque()
        self._completion_thread = None
        self._completion_stop = threading.Event()
        digest = participants_digest(self.num_ranks,
                                     dist.get_backend()
                                     if dist.is_initialized() else "none")
        self._wire_cache = WireProgramCache(digest)
        # The compiled hot loop's tier (ops/step_program.py): the
        # session's ProgramCache, handed out by runtime.
        self._step_cache = programs
        # name -> {rank: _Request}; insertion order is submission order
        # (reference: message_table, global_state.h:36).
        self._table = OrderedDict()
        self._first_seen = {}    # name -> perf_counter of first submission
        self._stall_warned = set()
        self._handles = {}       # handle -> "pending" | "inflight" | result
        # On a card, the (start, end) event pairs of each fused bucket's
        # copy in and of its unfuse, recorded on the engine's stream: the
        # spans of the stream that carries the exchange. Elapsed time
        # between events on a stream that shares the SMs with other work,
        # not the device time of the copies. Readers pop them.
        self.bucket_spans = deque(maxlen=4096)
        self._events = {}        # handle -> CUDA event its result waits on
        # On a card, the tuner's exposed wire time: the end events of the
        # fused buckets not yet handed over, and (consumer event, bucket
        # event) pairs waiting to complete (:meth:`_feed_exposure`).
        self._exposure_due = set()
        self._exposure = []
        self._next_handle = 0
        self._pending_bytes = 0
        self._next_seq = 0
        from .. import native
        self._native_lib = native.get_lib()
        self._response_cache = NativeResponseCache(self._native_lib,
                                                   config.cache_capacity)
        self._local_ranks = [self.rank]
        # Two-level allreduce and allgather over (cross, local) groups
        # of ``local_size`` ranks (reference: NCCLHierarchicalAllreduce,
        # MPIHierarchicalAllgather), each under its own flag.
        self._hier = None
        if config.hierarchical_allreduce or config.hierarchical_allgather:
            self._init_hierarchical(local_size)
        self._hier_ar = (self._hier if config.hierarchical_allreduce
                         else None)
        self._hier_ag = (self._hier if config.hierarchical_allgather
                         else None)
        self._multihost = self.num_ranks > 1
        self._coord = None
        self._ticker = None
        self._ticker_stop = threading.Event()
        self._last_cycle = 0.0
        if self._multihost:
            from ..coordinator import MultiHostCoordinator
            from ..utils.store_kv import StoreKV
            if store is None:
                store = dist.distributed_c10d._get_default_store()
            self._coord = MultiHostCoordinator(
                config, self.num_ranks, stats=stats, client=StoreKV(store),
                process_index=self.rank, process_count=self.num_ranks,
                namespace=namespace)
            if not config.ticker_disable:
                self._ticker = threading.Thread(
                    target=self._ticker_loop, name="hvd-torch-ticker",
                    daemon=True)
                self._ticker.start()
        # Flight recorder (diag/): installed by runtime.init before the
        # engine exists; cached so hot paths pay one attribute load.
        self._flight = diag.get()
        # Step-integrity guard and chaos injector (guard/), installed by
        # runtime.init before the engine: None by default, and every hook
        # below is then one attribute load and a skipped branch.
        self._guard = guard.get()
        self._inject = guard.inject.get()
        if self._guard is not None and self._coord is not None:
            # non-apply verdicts go into the decision log (the audit lane)
            self._guard.decision_sink = self.publish_guard
        # An elastic abort (a lost worker, a planned departure, a
        # hosts-updated interrupt) fails this session for good.
        self._elastic_abort = None
        # Autotune (autotune.py): the session's ParameterManager on
        # process 0 (runtime.init sets it), fed by every completed
        # bucket; above one rank its changes come back through the
        # decision log, and this records each one applied, in order
        # (equal on every rank: the point of routing through the log).
        self.autotuner = None
        self.applied_autotune = []
        metrics.registry().set_collect_hook("engine", self._collect_metrics)

    def _collect_metrics(self):
        # Exporter-thread gauge snapshot: len()/attribute reads are
        # GIL-atomic and a stale value is fine.
        metrics.ENGINE_QUEUE_DEPTH.set(len(self._table))  # hvdlint: disable=HVD002 -- relaxed gauge read
        metrics.ENGINE_PENDING_BYTES.set(self._pending_bytes)  # hvdlint: disable=HVD002 -- relaxed gauge read
        metrics.ENGINE_CACHE_HITS.set(self._response_cache.hits)
        metrics.ENGINE_CACHE_MISSES.set(self._response_cache.misses)
        metrics.ENGINE_INFLIGHT_DEPTH.set(len(self._inflight))  # hvdlint: disable=HVD002 -- relaxed gauge read
        metrics.ENGINE_WIRE_CACHE_HITS.set(self._wire_cache.hits)
        metrics.ENGINE_WIRE_CACHE_MISSES.set(self._wire_cache.misses)
        if self._step_cache is not None:
            metrics.STEP_PROGRAM_CACHE_HITS.set(self._step_cache.hits)
            metrics.STEP_PROGRAM_CACHE_MISSES.set(self._step_cache.misses)

    def step_program(self, signature, build):
        """Signature-keyed step programs (the compiled hot loop's cache
        tier, ops/step_program.py's gateway: the session's
        ProgramCache). Returns ``(program, was_hit, hits, misses)``."""
        prog, hit = self._step_cache.get(signature, build)
        return prog, hit, self._step_cache.hits, self._step_cache.misses

    def _init_hierarchical(self, local):
        """The (cross, local) mesh hierarchical collectives run over, or
        a loud warning when the topology has no two tiers (a user setting
        HOROVOD_HIERARCHICAL_ALLREDUCE or _ALLGATHER must never get
        silent flat behavior)."""
        from ..parallel.mesh import hierarchical_axes, hierarchical_mesh
        if (local <= 1 or local >= self.num_ranks
                or self.num_ranks % local != 0):
            _logger.warning(
                "HOROVOD_HIERARCHICAL_ALLREDUCE/ALLGATHER requested but the "
                "topology has no two-level structure (local_size=%d of %d "
                "ranks); falling back to flat collectives. Set "
                "HOROVOD_DCN_LOCAL_SIZE to define the local tier.",
                local, self.num_ranks)
            return
        mesh = hierarchical_mesh(self.device.type, self.num_ranks, local)
        self._hier = (mesh, hierarchical_axes(mesh))
        _logger.info("hierarchical collectives over a %dx%d (cross, local) "
                     "mesh", self.num_ranks // local, local)

    @property
    def hier_local_size(self):
        return self._hier[0].size(1) if self._hier is not None else 0

    @property
    def response_cache(self):
        return self._response_cache

    @property
    def wire_cache(self):
        return self._wire_cache

    @property
    def coordinator(self):
        return self._coord

    # ------------------------------------------------------------------ API

    def enqueue(self, op, tensor, name, rank=None, average=True, root_rank=0,
                compression=None, prescale=None, postscale=None,
                inplace=False):
        """Submit this rank's tensor; returns an async handle.

        Reference: EnqueueTensorAllreduce/Allgather/Broadcast
        (operations.cc:2013-2135) including the duplicate-name check at
        :2042. ``rank`` may only name this process's rank. ``inplace``
        lets a batch of this one request reduce the tensor itself."""
        if not torch.is_tensor(tensor):
            tensor = torch.as_tensor(tensor)
        if self._inject is not None:
            tensor = self._inject.on_enqueue(name, tensor)
        ready = None
        if tensor.is_cuda:
            if torch.cuda.is_current_stream_capturing():
                raise HorovodError(
                    "the eager engine cannot be captured into a CUDA graph; "
                    "a compiled step exchanges through its own collectives "
                    "(ops/step_program.py)")
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(tensor.device))
        with self._lock:
            if self._elastic_abort is not None:
                raise self._elastic_abort
            if self._shutdown:
                raise ShutDownError()
            if rank is not None and rank != self.rank:
                if not 0 <= rank < self.num_ranks:
                    raise ValueError(f"rank {rank} out of range "
                                     f"[0, {self.num_ranks})")
                raise ValueError(
                    f"rank {rank} is not owned by this process "
                    f"(local ranks: {self._local_ranks})")
            handle = self._next_handle
            self._next_handle += 1
            self._handles[handle] = "pending"
            pending = self._table.get(name)
            created = False
            if pending is None:
                pending = self._table[name] = {}
                created = True
                self._first_seen[name] = time.perf_counter()
                self.timeline.negotiate_start(name, op)
            if self.rank in pending:
                # Duplicate-name check parity (operations.cc:2042): roll
                # back what this call added before raising.
                if created:
                    del self._table[name]
                    self._first_seen.pop(name, None)
                self._handles.pop(handle)
                raise DuplicateNameError()
            self._next_seq += 1
            pending[self.rank] = _Request(
                op, self.rank, name, tensor, handle, average=average,
                root_rank=root_rank, compression=compression,
                prescale=prescale, postscale=postscale, seq=self._next_seq,
                inplace=inplace, ready=ready)
            self._pending_bytes += _nbytes(tensor)
            fr = self._flight
            if fr is not None:
                fr.record("enqueue", name, _OP_NAMES[op], _nbytes(tensor),
                          _dtype_name(tensor.dtype))
            wd = _recorder.watchdog()
            if wd is not None:
                wd.track(_Watch(self, name, _OP_NAMES[op], handle))
            # Mirror the reference's cycle trigger: once enough bytes are
            # pending to fill a fusion buffer, run a cycle eagerly rather
            # than waiting for synchronize() (the 5 ms cycle waking up).
            cycled = self._pending_bytes >= self.config.fusion_threshold
            if cycled:
                self._run_cycle()
        if cycled:
            self._relieve()
        return handle

    def poll(self, handle):
        """True once the op completed (reference: horovod_torch_poll,
        torch/mpi_ops_v2.cc:223-226). A launched collective not yet
        completed is not done: while it is still queued it is completed
        here, its wait outside the lock; one another thread took polls
        False until it lands."""
        with self._lock:
            if self._handles.get(handle, "pending") == "pending":
                self._run_cycle()
            recs = self._take_inflight_locked(handle)
        for rec in recs:
            self._complete_inflight(rec)
        self._relieve()
        with self._lock:
            return not isinstance(self._handles.get(handle, "pending"), str)

    def _take_inflight_locked(self, handle):
        """The queued collectives up to and including ``handle``'s, taken
        off the queue in order for the caller to complete outside the
        lock (none when another thread already holds it)."""
        recs = []
        if self._handles.get(handle) == "inflight":
            while self._owns_inflight_locked(handle):
                recs.append(self._inflight.popleft())
        return recs

    def synchronize(self, handle):
        """Block until completion; return the result (a tensor on the
        input's device, the caller's stream ordered after it) or raise
        the op's error (reference: horovod_torch_wait_and_clear,
        torch/mpi_ops_v2.cc:228-234)."""
        deadline_kill = self.config.stall_shutdown_time_seconds
        t0 = time.perf_counter()
        while True:
            with self._cv:
                # Resolved-handle fast path BEFORE running a cycle: a
                # batch of N fused tensors resolves N handles at once, and
                # synchronizing the other N-1 must not pay a cycle each.
                result = self._handles.get(handle)
                if result is None:
                    raise HorovodError(f"unknown handle {handle}")
                cycled = result == "pending"
                if cycled:
                    self._run_cycle()
                recs = self._take_inflight_locked(handle)
            # Our collective and the ones ahead of it, completed in order
            # with the engine lock released across their waits.
            for rec in recs:
                self._complete_inflight(rec)
            if cycled:
                self._relieve()
            with self._cv:
                result = self._handles.get(handle)
                if result is not None and not isinstance(result, str):
                    del self._handles[handle]
                    event = self._events.pop(handle, None)
                    if isinstance(result, Exception):
                        raise result
                    return self._hand_over(result, event)
                if not self.config.stall_check_disable \
                        and not self._multihost:
                    self._check_stalls_locked()
                waited = time.perf_counter() - t0
                if deadline_kill > 0 and waited > deadline_kill:
                    # The reference shuts the whole job down
                    # (operations.cc:1458-1461); here the waiting handle
                    # raises.
                    raise StalledTensorError(
                        "One or more rank is stalled for longer than "
                        f"{int(deadline_kill)} seconds. Will shutdown.")
                self._cv.wait(max(self.config.cycle_time_ms, 1.0) / 1000.0)

    def _hand_over(self, result, event):
        """The result for the caller: ``{rank: tensor}``, with the
        caller's stream ordered after the engine's work on it. The first
        hand-over of a fused bucket the tuner scores records an event on
        the caller's stream before its wait (:meth:`_feed_exposure`).
        Caller holds the engine lock."""
        if event is not None:
            caller = torch.cuda.current_stream(self.device)
            if event in self._exposure_due:
                self._exposure_due.discard(event)
                reached = torch.cuda.Event(enable_timing=True)
                reached.record(caller)
                self._exposure.append((reached, event))
            caller.wait_event(event)
            for t in result.values():
                if t.is_cuda:
                    t.record_stream(caller)
        if self._exposure:
            self._feed_exposure()
        return result

    def _feed_exposure(self):
        """Feed the tuner a card's exposed wire time (the reference's
        blocking readback wait, which a stream wait does not give the
        host): how long each consumer stream stalled at a bucket's
        hand-over, from its event before the wait to the bucket's end
        event, 0 when the bucket ended first. Folds the pairs whose
        events have both completed; never waits. Caller holds the engine
        lock."""
        waiting = []
        for reached, done in self._exposure:
            if not (reached.query() and done.query()):
                waiting.append((reached, done))
            elif self.autotuner is not None:
                exposed = max(reached.elapsed_time(done), 0.0) / 1e3
                self.autotuner.record_overlap(0.0, exposed)
        self._exposure = waiting

    def _ticker_loop(self):
        """Control-plane cadence: publish the pending snapshot and (on
        process 0) run ``coordinate()`` every cycle time, so a process
        that submits and then computes does not stall its peers until its
        next synchronize (reference: the background thread's loop,
        operations.cc:985,1434-1449). Decisions are applied, and
        collectives launched, only by application threads in
        ``_run_cycle``."""
        def _interval():
            return max(self.config.cycle_time_ms, 1.0) / 1000.0

        backoff = 1.0
        interval = _interval()
        while not self._ticker_stop.wait(min(interval * backoff, 1.0)
                                         if interval < 1.0 else interval):
            interval = _interval()
            if self.config.elastic and self._elastic_abort is None:
                try:
                    self._coord.publish_liveness()
                    self._coord.elastic_round()
                except Exception:  # noqa: BLE001 — app threads surface it
                    _logger.debug("liveness round failed", exc_info=True)
            if time.perf_counter() - self._last_cycle < interval:
                backoff = 1.0
                continue
            if not self._lock.acquire(blocking=False):
                backoff = 1.0
                continue
            try:
                if self._shutdown:
                    return
                if time.perf_counter() - self._last_cycle < interval:
                    backoff = 1.0
                    continue
                pending_meta = [(req.seq, name, req.meta())
                                for name, pend in self._table.items()  # hvdlint: disable=HVD002 -- lock IS held (try-acquire above)
                                for req in pend.values()]
            finally:
                self._lock.release()
            busy = bool(pending_meta)
            try:
                if not self._coord.fast_lane_would_hit(pending_meta):
                    self._coord.publish(pending_meta)
                if self._coord.aggregate_round():
                    busy = True
                if self._coord.coordinate():
                    busy = True
            except Exception:  # app threads surface transport errors
                _logger.debug("ticker cycle failed", exc_info=True)
            backoff = 1.0 if busy else min(backoff * 2.0, 1024.0)

    def shutdown(self):
        """Shut this process's engine down; with several ranks, announce
        the exit so peers fail fast with ShutDownError instead of stalling
        (reference: operations.cc:135-140,1664-1667,1882-1886). Launched
        buckets are drained first, so their handles resolve to the
        exchanged results; queued handles then fail with ShutDownError."""
        with self._lock:
            if self._closed:
                return
            self._closed = self._shutdown = True
        self._drain_inflight()
        self._ticker_stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=5.0)
        metrics.registry().remove_collect_hook("engine")
        with self._lock:
            for h, v in list(self._handles.items()):
                if v == "pending":
                    self._handles[h] = ShutDownError()
            self._wire_cache.invalidate()
            if self._coord is not None:
                try:
                    self._coord.publish_shutdown()
                    self._coord.coordinate()
                except Exception:  # KV store may already be gone
                    _logger.debug("shutdown announce failed", exc_info=True)
                finally:
                    self._coord.close()
            self._cv.notify_all()
        # What a cycle racing this shutdown launched.
        self._drain_inflight()

    # ------------------------------------------------------ overlap pipeline

    def _pipeline_depth(self):
        return max(int(self.config.pipeline_depth), 0)

    def _ensure_completion_thread(self):
        t = self._completion_thread
        if (t is None or not t.is_alive()) \
                and not self._completion_stop.is_set():
            self._completion_thread = threading.Thread(
                target=self._completion_loop, name="hvd-torch-completer",
                daemon=True)
            self._completion_thread.start()

    def _completion_loop(self):
        """Complete launched buckets so handles resolve even when the
        application never synchronizes promptly. The wait on the
        collective runs WITHOUT the engine lock; only handle resolution
        takes it."""
        if self._cuda:
            torch.cuda.set_device(self.device)
        while True:
            rec = None
            with self._cv:
                if self._inflight:
                    rec = self._inflight.popleft()
                elif self._completion_stop.is_set():
                    return
                else:
                    self._cv.wait(0.2)
                    continue
            try:
                self._complete_inflight(rec)
            except Exception:  # noqa: BLE001 — the loop must survive
                _logger.exception("completion thread failed on a bucket")

    def _stream_ctx(self):
        if self._cuda:
            return torch.cuda.stream(self._stream)
        return _NULL_CTX

    def _clock_start(self):
        """Start a wire clock: a CUDA event on the engine's stream, or the
        host's time."""
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            return ev
        return time.perf_counter()

    def _clock_stop(self, op_stat, nbytes, start, on_resolve):
        """Record one wire op in the stats: on a card between two events
        of the engine's stream, resolved when the second completes
        (stats.py), on the CPU on the host's clock."""
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            self.stats.record_events(op_stat, nbytes, start, end, on_resolve)
        else:
            span = time.perf_counter() - start
            self.stats.record(op_stat, nbytes, span)
            on_resolve(span)

    def _wire_end(self, op, name, nbytes, n, wait=None):
        """The callback a wire op's clock runs with its span: the wire
        profiler and the flight recorder's ``wire_end``."""
        def on_resolve(span):
            waited = span if wait is None else wait
            self._observe_wire(op, nbytes, span)
            # on a card the host's wait does not block: the exposed time
            # is the consumer stream's, fed at the hand-over
            if op == "allreduce" and self.autotuner is not None \
                    and not self._cuda:
                self.autotuner.record_overlap(max(span - waited, 0.0),
                                              waited)
            fr = self._flight
            if fr is not None:
                fr.record("wire_end", name, op, nbytes,
                          extra={"span": span, "wait": waited,
                                 "hidden": max(span - waited, 0.0),
                                 "n": n})
        return on_resolve

    def _complete_inflight(self, rec):
        """Wait + finish (unfuse, handle resolution) for one launched
        collective. The caller does not hold the engine lock: the wait
        runs without it (on a card it only orders the engine's stream
        after the collective), the finish under it."""
        err = None
        t_block = time.perf_counter()
        try:
            with self._stream_ctx():
                rec.work.wait()
        except Exception as e:  # noqa: BLE001 — surfaces on the handles
            err = peer_error(e)
        wait = time.perf_counter() - t_block
        metrics.ENGINE_READBACK_WAIT_SECONDS.observe(wait)
        with self._cv:
            try:
                if err is None:
                    with self._stream_ctx():
                        rec.finish(wait)
                else:
                    self._fail_inflight_locked(rec, err)
            except Exception as e:  # noqa: BLE001 — a finish must never
                self._fail_inflight_locked(rec, e)  # strand a handle
            finally:
                metrics.ENGINE_INFLIGHT_DEPTH.set(len(self._inflight))
                self._cv.notify_all()

    def _launched_locked(self, rec):
        """Queue a launched collective for completion: its handles turn
        "inflight", and the completion thread (depth > 0) or the caller's
        backpressure (:meth:`_relieve`) completes it. Caller holds the
        lock."""
        for handle in rec.handles:
            if self._handles.get(handle) == "pending":
                self._handles[handle] = "inflight"
        self._inflight.append(rec)
        metrics.ENGINE_INFLIGHT_DEPTH.set(len(self._inflight))
        metrics.ENGINE_INFLIGHT_DEPTH_HIST.observe(len(self._inflight))
        if self._pipeline_depth() > 0:
            self._ensure_completion_thread()
        self._cv.notify_all()

    def _relieve(self):
        """Backpressure after a cycle, with the lock released: complete
        the oldest launched collectives until at most
        ``HOROVOD_PIPELINE_DEPTH`` are in flight (every one at depth 0,
        the synchronous mode)."""
        depth = self._pipeline_depth()
        while True:
            with self._cv:
                if len(self._inflight) <= depth:
                    return
                rec = self._inflight.popleft()
            self._complete_inflight(rec)

    def _owns_inflight_locked(self, handle):
        """Whether ``handle``'s collective is still queued (a waiter can
        complete it inline). Caller holds the lock."""
        return any(handle in rec.handles for rec in self._inflight)

    def _fail_inflight_locked(self, rec, err):
        """Resolve a collective's handles to ``err`` and close its
        timeline spans. Caller holds the lock."""
        for handle in rec.handles:
            v = self._handles.get(handle)
            if v is not None and not isinstance(v, Exception):
                self._handles[handle] = err
        for name in rec.names:
            if rec.activity:
                self.timeline.activity_end(name)
            self.timeline.end(name)

    def _drain_inflight(self):
        """Complete every launched bucket (shutdown path): stop the
        completion thread, let it finish what it owns, then complete the
        rest inline."""
        self._completion_stop.set()
        with self._cv:
            self._cv.notify_all()
        t = self._completion_thread
        if t is not None and t.is_alive():
            t.join(timeout=10.0)
            if t.is_alive():
                _logger.warning(
                    "completion thread still blocked on an in-flight "
                    "collective at shutdown; abandoning it (daemon)")
        while True:
            with self._cv:
                if not self._inflight:
                    break
                rec = self._inflight.popleft()
            self._complete_inflight(rec)

    # ---------------------------------------------------------- negotiation

    def _run_cycle(self):
        """One coordinator cycle: collect ready names, validate, fuse,
        launch (reference: RunLoopOnce, operations.cc:1434-1843). The
        caller completes what it launched past the pipeline's depth with
        the lock released (:meth:`_relieve`)."""
        metrics.ENGINE_CYCLES.inc()
        with self._lock, metrics.ENGINE_CYCLE_SECONDS.time():
            return self._run_cycle_body_locked()

    def _run_cycle_body_locked(self):
        self.timeline.mark_cycle_start()
        if self._multihost:
            return self._run_cycle_multihost()
        ready = [name for name, pend in self._table.items()
                 if len(pend) == self.num_ranks]
        if not ready:
            return
        cache = self._response_cache
        entries = []
        for name in ready:
            pending = self._table.pop(name)
            self._first_seen.pop(name, None)
            self._stall_warned.discard(name)
            self.timeline.negotiate_end(name)
            reqs = [pending[r] for r in sorted(pending)]
            self._pending_bytes -= sum(_nbytes(r.tensor) for r in reqs)
            if cache.lookup(reqs[0]):
                entries.append((_Entry(name, reqs[0].op, pending), True))
                continue
            resp = construct_response(name, [r.meta() for r in reqs],
                                      self.num_ranks)
            if resp.error is not None:
                exc = MismatchError(resp.error)
                for r in reqs:
                    self._handles[r.handle] = exc
                continue
            for r in reqs:
                cache.put(r)
            entry = _Entry(name, reqs[0].op, pending)
            entry.sizes = resp.tensor_sizes
            entries.append((entry, False))
        if entries:
            self._execute(entries)

    def _run_cycle_multihost(self):
        """Publish pending set -> (process 0) decide -> apply decisions in
        order. The collectives launch in decision order on every rank."""
        self._last_cycle = time.perf_counter()
        try:
            self._run_cycle_multihost_locked()
        finally:
            self._last_cycle = time.perf_counter()

    def _run_cycle_multihost_locked(self):
        pending_meta = [(req.seq, name, req.meta())
                        for name, pend in self._table.items()
                        for req in pend.values()]
        # Local-replay fast lane (RunBypass analog): validated steady
        # state executes straight from the decision registry.
        if not self._shutdown:
            replay = self._coord.fast_replay_entries(pending_meta)
            if replay is not None:
                entries = self._entries_from_decision_locked(replay)
                if entries:
                    self._execute(entries)
                return
        self._coord.publish(pending_meta, shutdown=self._shutdown)
        self._coord.aggregate_round()
        fr = self._flight
        if fr is not None:
            fr.record("negotiate_submit", extra={"n": len(pending_meta)})
            fr.last_cycle_wall = time.time()
        self._coord.coordinate()
        for decision in self._coord.fetch_decisions(
                timeout_ms=max(int(self.config.cycle_time_ms * 10), 50)):
            if decision.get("warning"):
                _logger.warning(decision["warning"])
                metrics.ENGINE_STALL_WARNINGS.inc()
            if decision.get("autotune"):
                self._apply_autotune_locked(decision["autotune"])
            if decision.get("guard") and self._guard is not None:
                # Audit lane: every process sees the same verdict at the
                # same index; the monitor screams if its ladder disagreed.
                self._guard.apply_decision(decision["guard"])
            if decision.get("abort"):
                self._apply_abort_locked(decision["abort"])
                return
            if decision.get("shutdown"):
                # A peer exited cooperatively after draining its own
                # launched collectives: ours complete as usual, and every
                # handle not launched yet fails fast
                # (operations.cc:1882-1886).
                self._shutdown = True
                for h, v in list(self._handles.items()):
                    if v == "pending":
                        self._handles[h] = ShutDownError()
                return
            entries = self._entries_from_decision_locked(
                decision["tensors"])
            if entries:
                self._execute(entries)

    def _apply_abort_locked(self, info):
        """Elastic abort (a lost worker, a planned departure, or a
        hosts-updated interrupt): every handle not completed yet fails
        with :class:`WorkerLostError` / :class:`HostsUpdatedError`, the
        pending table is dropped whole (its submissions belong to the
        dead membership and re-submit after recovery), and the caches
        keyed by the old membership die with it: the response cache, the
        wire layouts and the session's step programs (their graphs hold
        the old group's collectives). Later submissions raise the same
        error; recovery builds a new session (elastic/runner.py)."""
        kind = info.get("kind")
        if kind == "hosts_updated":
            exc = HostsUpdatedError(epoch=info.get("epoch", 0))
        elif kind == "planned_departure":
            exc = HostsUpdatedError(epoch=info.get("epoch", 0),
                                    lost_pids=info.get("lost_pids", ()))
        else:
            lost = list(info.get("lost_pids", ()))
            exc = WorkerLostError(lost_pids=lost,
                                  epoch=info.get("epoch", 0))
            metrics.ELASTIC_WORKERS_LOST.inc(max(len(lost), 1))
        self._elastic_abort = exc
        self._response_cache.clear()
        self._wire_cache.invalidate()
        if self._step_cache is not None:
            self._step_cache.clear()
        for h, v in list(self._handles.items()):
            if isinstance(v, str):
                self._handles[h] = exc
        for name in self._table:
            self.timeline.end(name)
        self._table.clear()
        self._first_seen.clear()
        self._pending_bytes = 0
        fr = self._flight
        if fr is not None:
            fr.record("elastic_abort", extra=dict(info))
        diag.dump_post_mortem("elastic_abort", extra={"abort": dict(info)})
        self._cv.notify_all()

    def _apply_autotune_locked(self, at):
        """SyncParams apply point (parameter_manager.cc:223-262): every
        process, the tuning process 0 included, changes its knobs here,
        at the same decision index, so every later decision's fusion
        plan (and so the buckets each rank sends) is the same on every
        rank."""
        self.config.fusion_threshold = int(at["fusion"])
        self.config.cycle_time_ms = float(at["cycle"])
        self.config.padding_algo = int(at["padding"])
        if at.get("depth") is not None:
            # in-flight depth is host-local (completion cadence, not the
            # buckets), synced anyway so every process runs the tuned
            # pipeline
            self.config.pipeline_depth = int(at["depth"])
        self.applied_autotune.append(
            (int(at["fusion"]), float(at["cycle"]), int(at["padding"]),
             None if at.get("depth") is None else int(at["depth"])))

    def publish_autotune(self, fusion, cycle, padding, depth=None):
        """Multi-process ParameterManager hook: route tuned parameters
        through the decision log instead of changing the config here
        (reference: SyncParams, parameter_manager.cc:223-262)."""
        self._coord.append_autotune(fusion, cycle, padding, depth)

    def publish_guard(self, verdict):
        """Guard decision-log hook: record a non-apply step verdict in
        the coordinator's log (advisory; ranks act on their own,
        bit-identical verdicts)."""
        self._coord.append_guard(verdict)

    def _guarded_wire(self, dispatch, op):
        """Run one wire dispatch under the guard's chaos injection and
        bounded retry. Retryable: :class:`TransientCollectiveError` and a
        raw backend ``RuntimeError``/``OSError`` of the dispatch itself;
        every other error propagates at once. Exponential backoff from
        ``HOROVOD_GUARD_RETRY_BASE_SECONDS`` under
        ``HOROVOD_GUARD_RETRY_DEADLINE_SECONDS``. With no injector and no
        retries this is ``dispatch()``."""
        if self._inject is None and self.config.guard_retry <= 0:
            return dispatch()
        retries = self.config.guard_retry
        deadline = time.monotonic() + self.config.guard_retry_deadline_seconds
        base = self.config.guard_retry_base_seconds
        attempt = 0
        while True:
            try:
                if self._inject is not None:
                    # per attempt: a count=1 fault costs exactly one retry
                    self._inject.on_dispatch(op)
                return dispatch()
            except HorovodError as err:
                if not isinstance(err, TransientCollectiveError):
                    raise
                last = err
            except (RuntimeError, OSError) as err:
                last = err
            attempt += 1
            now = time.monotonic()
            if retries <= 0 or attempt > retries or now >= deadline:
                raise last
            delay = min(base * (2 ** (attempt - 1)),
                        max(deadline - now, 0.0))
            metrics.GUARD_RETRIES.inc()
            fr = self._flight
            if fr is not None:
                fr.record("guard_retry", "", op,
                          extra={"attempt": attempt, "delay_s": delay,
                                 "error": str(last)[:200]})
            _logger.warning(
                "guard: transient %s dispatch failure (attempt %d/%d), "
                "retrying in %.3fs: %s", op, attempt, retries, delay, last)
            time.sleep(delay)

    def _entries_from_decision_locked(self, tensors):
        """Turn decided per-name records into executable entries (shared
        by the fetched-decision path and the local-replay fast lane). The
        response cache counts this rank's repeats, as at one rank."""
        entries = []
        for t in tensors:
            name = t["name"]
            pend = self._table.get(name)
            if pend is None:
                continue
            if t["error"]:
                # Error decisions deliver unconditionally: the coordinator
                # fails a name globally (operations.cc:325-527).
                self._table.pop(name)
                self._first_seen.pop(name, None)
                reqs = [pend[r] for r in sorted(pend)]
                self._pending_bytes -= sum(_nbytes(r.tensor) for r in reqs)
                self.timeline.negotiate_end(name)
                exc = MismatchError(t["error"])
                for r in reqs:
                    self._handles[r.handle] = exc
                continue
            # Staleness guard: a backlogged decision must not execute a
            # later submission that reuses the name with other metadata.
            reqs_probe = list(pend.values())
            meta0 = reqs_probe[0].meta()
            if meta0.op != t["op"]:
                continue
            if t.get("dtype") is not None and meta0.dtype != t["dtype"]:
                continue
            tshape = t.get("shape")
            if tshape is not None:
                if t["op"] == ALLGATHER:
                    if list(meta0.shape[1:]) != list(tshape[1:]):
                        continue
                elif list(meta0.shape) != list(tshape):
                    continue
            if t.get("sizes") is not None and any(
                    int(r.tensor.shape[0]) != t["sizes"][r.rank]
                    for r in reqs_probe):
                continue
            self._table.pop(name)
            self._first_seen.pop(name, None)
            reqs = [pend[r] for r in sorted(pend)]
            self._pending_bytes -= sum(_nbytes(r.tensor) for r in reqs)
            self.timeline.negotiate_end(name)
            hit = self._response_cache.lookup(reqs[0])
            if not hit:
                self._response_cache.put(reqs[0])
            entry = _Entry(name, t["op"], pend)
            entry.sizes = t.get("sizes")
            entries.append((entry, hit))
        return entries

    def _check_stalls_locked(self):
        """Warn about names stuck waiting for a subset of ranks (reference:
        CheckForStalledTensors, operations.cc:815-896). At one rank; with
        several, the coordinator's decision log carries the warning."""
        now = time.perf_counter()
        warn_after = self.config.stall_check_time_seconds
        missing_by_rank = {}
        for name, pend in self._table.items():
            if name in self._stall_warned:
                continue
            if now - self._first_seen.get(name, now) <= warn_after:
                continue
            self._stall_warned.add(name)
            self._response_cache.invalidate_name(name)
            for r in range(self.num_ranks):
                if r not in pend:
                    missing_by_rank.setdefault(r, []).append(name)
        if missing_by_rank:
            metrics.ENGINE_STALL_WARNINGS.inc()
            msg = ["One or more tensors were submitted to be reduced, "
                   "gathered or broadcasted by subset of ranks and are "
                   f"waiting for remainder of ranks for more than "
                   f"{int(warn_after)} seconds. This may indicate that "
                   "different ranks are trying to submit different tensors or "
                   "that only subset of ranks is submitting tensors, which "
                   "will cause deadlock. \nStalled ranks:"]
            for r in sorted(missing_by_rank):
                names = missing_by_rank[r]
                shown = ", ".join(names[:6])
                if len(names) > 6:
                    shown += " ..."
                msg.append(f"\n{r}: [{shown}]")
            _logger.warning("".join(msg))

    # ------------------------------------------------------------ execution

    def _execute(self, entries):
        """Fuse + run ready entries (reference: FuseResponses
        operations.cc:577-700 + PerformOperation operations.cc:722-812).
        Allreduces fuse by wire dtype under the threshold; allgather,
        broadcast and alltoall run per entry."""
        allreduces, singles = [], []
        for entry, cached in entries:
            if entry.op == ALLREDUCE:
                allreduces.append((entry, cached, self._wire_dtype(entry)))
            else:
                singles.append((entry, cached))
        for batch, wire in self._plan_fusion(allreduces):
            self._execute_allreduce_fused_locked(batch, wire)
        for entry, cached in singles:
            if entry.op == ALLGATHER:
                self._execute_allgather(entry)
            elif entry.op == BROADCAST:
                self._execute_broadcast(entry)
            elif entry.op == ALLTOALL:
                self._execute_alltoall(entry)

    def _plan_fusion(self, allreduces):
        """Partition ready allreduces into fused batches under the fusion
        threshold through the native planner (csrc/fusion.cc: the
        reference's same-dtype look-ahead, FuseResponses,
        operations.cc:577-700)."""
        if not allreduces:
            return []
        n = len(allreduces)
        dtype_ids = {}
        nb = (ctypes.c_int64 * n)(*[e.nbytes for e, _, _ in allreduces])
        dt = (ctypes.c_int32 * n)(
            *[dtype_ids.setdefault(str(w), len(dtype_ids))
              for _, _, w in allreduces])
        groups = (ctypes.c_int32 * n)()
        ngroups = self._native_lib.hvd_fusion_plan(
            nb, dt, n, int(self.config.fusion_threshold), groups)
        batches = [[] for _ in range(ngroups)]
        wires = [None] * ngroups
        for i, (entry, cached, wire) in enumerate(allreduces):
            batches[groups[i]].append((entry, cached))
            wires[groups[i]] = wire
        return list(zip(batches, wires))

    def _wire_dtype(self, entry):
        req = entry.requests[min(entry.requests)]
        if req.compression is not None:
            probe, _ = req.compression.compress(
                torch.zeros((), dtype=entry.dtype))
            return _wire(probe.dtype)
        return _wire(entry.dtype)

    def _fused_nelem(self, counts):
        """Total fused element count, honoring the fork's power-of-two
        padding (PADDING_ALGO=1, ops/mpi_operations.cc:24-63) and, under
        hierarchical allreduce, a multiple of the local tier size."""
        total = sum(counts)
        if self.config.padding_algo == 1:
            total = next_power_of_two(total)
        if self._hier_ar is not None:
            local = self.hier_local_size
            total = ((total + local - 1) // local) * local
        return total

    def _observe_wire(self, op, nbytes, seconds):
        """The fork's wire profiler feed: one histogram observation per
        wire op, labeled by power-of-two message-size bin."""
        size_bin = next_power_of_two(max(int(nbytes), 1))
        metrics.WIRE_SECONDS.labels(op=op, size_bin=str(size_bin)) \
            .observe(seconds)
        if self.autotuner is not None:
            # the largest-message guard's feed: on a card the span runs
            # from the event after the copy-in (the engine's stream past
            # its wait on the producers) to the event after the
            # collective's wait, never the wait behind the backward
            self.autotuner.record_wire(nbytes, seconds)

    def _layout(self, batch, wire_dtype):
        """(offsets, counts, total) of a batch's fused buffer, through the
        wire cache (one entry per bucket signature)."""
        segs = tuple((tuple(e.requests[min(e.requests)].tensor.shape),
                      _dtype_name(e.dtype)) for e, _ in batch)
        sig = ("psum", _dtype_name(wire_dtype), segs,
               int(self.config.padding_algo))

        def build():
            counts = [math.prod(shape) for shape, _ in segs]
            offsets = [0]
            for c in counts:
                offsets.append(offsets[-1] + c)
            return offsets, counts, self._fused_nelem(counts)
        return self._wire_cache.get(sig, build)

    def _execute_allreduce_fused_locked(self, batch, wire_dtype):
        """Fill one fused buffer on the engine's stream, launch its
        all-reduce and queue the bucket for completion (up to
        ``HOROVOD_PIPELINE_DEPTH`` in flight)."""
        for e, _ in batch:
            self.timeline.start(e.name, ALLREDUCE)
            self.timeline.activity_start(e.name, tl.MEMCPY_IN_FUSION_BUFFER)
        offsets, counts, total = self._layout(batch, wire_dtype)
        nbytes = total * wire_dtype.itemsize
        if self.config.fusion_threshold > 0:
            metrics.ENGINE_FUSION_FILL.observe(
                nbytes / self.config.fusion_threshold)
        metrics.ENGINE_BUCKET_FLUSHES.inc()
        # every fused bucket's result stays on its device (one result
        # path: to_host is ignored)
        metrics.ENGINE_DEVICE_BUCKETS.inc()
        reqs = [e.requests[self.rank] for e, _ in batch]
        with self._stream_ctx():
            for req in reqs:
                if req.ready is not None:
                    self._stream.wait_event(req.ready)
                    req.tensor.record_stream(self._stream)
            fill_start = self._clock_start() if self._cuda else None
            req0 = reqs[0]
            if (len(reqs) == 1 and req0.inplace and total == counts[0]
                    and req0.tensor.dtype == wire_dtype
                    and req0.tensor.is_contiguous()
                    and req0.prescale is None
                    and req0.tensor.device == self.device):
                # A bucket of one in-place request (a tensor at or above
                # the threshold always goes alone): reduce the tensor
                # itself, no copy in or out.
                buf = req0.tensor.view(-1)
            else:
                buf = torch.empty(total, dtype=wire_dtype,
                                  device=self.device)
                for i, req in enumerate(reqs):
                    flat = req.tensor.reshape(-1)
                    if req.prescale is not None:
                        flat = flat * req.prescale
                    buf[offsets[i]:offsets[i + 1]].copy_(flat)
                if total > offsets[-1]:
                    buf[offsets[-1]:].zero_()
            for e, _ in batch:
                self.timeline.activity_end(e.name)
                self.timeline.activity_start(e.name, tl.XLA_ALLREDUCE)
            op_stat = ("allreduce_cached" if all(c for _, c in batch)
                       else "allreduce")
            slim = [(e.name, e.dtype,
                     tuple((r, req.handle, tuple(req.tensor.shape),
                            req.average, req.postscale, req.tensor.device)
                           for r, req in e.requests.items()))
                    for e, _ in batch]
            fr = self._flight
            if fr is not None:
                fr.record("dispatch", slim[0][0], "allreduce", nbytes,
                          _dtype_name(wire_dtype),
                          extra={"n": len(slim),
                                 "names": [n for n, _, _ in slim[:16]]})
            if self._inject is not None:
                corrupted = self._inject.on_rows(
                    buf, tuple(n for n, _, _ in slim))
                if corrupted is not buf:
                    buf.copy_(corrupted)
            start = self._clock_start()
            fill = None if fill_start is None else (fill_start, start)
            if self._hier_ar is not None:
                self._guarded_wire(lambda: self._hier_allreduce(buf),
                                   "allreduce")
                work = _DONE
            else:
                work = self._guarded_wire(
                    lambda: dist.all_reduce(buf, async_op=True), "allreduce")

        def finish(wait):
            self._clock_stop(op_stat, nbytes, start,
                             self._wire_end("allreduce", slim[0][0], nbytes,
                                            len(slim), wait=wait))
            unfuse = self._clock_start() if self._cuda else None
            done = self._scatter_fused_results_locked(slim, offsets, buf)
            if done is not None:
                self.bucket_spans.append(fill + (unfuse, done))
                if self.autotuner is not None:
                    self._exposure_due.add(done)
            if self.autotuner is not None:
                # one fused collective is one sample step (the
                # reference's Update): its unpadded bytes
                self.autotuner.record_bytes(
                    offsets[-1] * wire_dtype.itemsize)

        self._launched_locked(_InFlight(
            [n for n, _, _ in slim],
            [h for _, _, rqs in slim for _, h, *_ in rqs], work, finish))

    def _hier_allreduce(self, buf):
        """The two-level sum of ``buf`` in place (ops/collectives.py
        ``hierarchical_allreduce``, its own stats record suppressed: the
        engine records the bucket)."""
        mesh, (ici, dcn) = self._hier_ar
        with untraced():
            buf.copy_(hierarchical_allreduce(buf, ici, dcn, average=False,
                                             mesh=mesh))

    def _hier_allgather(self, gather, out, block):
        """The two-stage allgather of ``block`` into ``out``: within the
        local tier first, then across hosts, whose blocks arrive in
        (cross, local) order, the global rank order (the JAX package's
        ``_jit_allgather_rows_hier``). Returns the cross stage's Work."""
        mesh = self._hier_ag[0]
        local = self.hier_local_size
        host = block.new_empty((local * block.shape[0],) + block.shape[1:])
        with record_function("hvd_ici"):
            gather(host, block, group=mesh.get_group("local"))
        with record_function("hvd_dcn"):
            return gather(out, host, group=mesh.get_group("cross"),
                          async_op=True)

    def _scatter_fused_results_locked(self, batch, offsets, buf):
        """Unfuse a completed bucket into per-handle results (reference:
        MemcpyOutFusionBuffer; ops/collectives.py ``unfuse_segments``):
        views of the bucket, averaged in place, or copies where the dtype
        or a postscale differs. Caller holds the engine lock and the
        engine's stream is current."""
        for name, _, _ in batch:
            self.timeline.activity_end(name)
            self.timeline.activity_start(name, tl.MEMCPY_OUT_FUSION_BUFFER)
        segs = []
        for i, (name, dtype, reqs) in enumerate(batch):
            _, _, shape, average, postscale, _ = reqs[0]
            segs.append((offsets[i], offsets[i + 1] - offsets[i], shape,
                         dtype, average, postscale))
        if self._guard is not None:
            # health of the REDUCED bucket, before the average: identical
            # on every rank; read by the monitor at its end_step
            health = segment_health(buf, segs)
            ready = None
            if self._cuda:
                ready = torch.cuda.Event()
                ready.record(self._stream)
            self._guard.note_device_health([n for n, _, _ in batch], health,
                                           ready)
        outs = unfuse_segments(buf, segs, self.num_ranks, inplace=True)
        for (name, _, reqs), out in zip(batch, outs):
            for r, handle, *_, dev in reqs:
                self._complete_locked(handle, r, out.to(dev))
            self.timeline.activity_end(name)
            self.timeline.end(name)
        event = None
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record(self._stream)
            for _, _, reqs in batch:
                for _, handle, *_ in reqs:
                    self._events[handle] = event
        return event

    def _single_op(self, entry, op, wire_op, nbytes, launch, finish):
        """Launch one per-entry collective on the engine's stream, after
        its producer: ``launch()`` returns its Work, and the collective
        is queued for completion, where ``finish()`` builds the result
        once the Work is waited on (the engine's stream ordered after
        it). A launch that raises resolves the handle with the error."""
        name = entry.name
        req = entry.requests[self.rank]
        self.timeline.start(name, op)
        if wire_op is not None:
            self.timeline.activity_start(name, wire_op)
        fr = self._flight
        with self._stream_ctx():
            if req.ready is not None:
                self._stream.wait_event(req.ready)
                req.tensor.record_stream(self._stream)
            if fr is not None:
                fr.record("dispatch", name, _OP_NAMES[op], nbytes,
                          _dtype_name(entry.dtype))
            start = self._clock_start()
            try:
                work = launch()
            except Exception as e:  # noqa: BLE001 — the handle carries it
                work = e
        rec = _InFlight([name], [req.handle], work, None,
                        activity=wire_op is not None)
        if isinstance(work, Exception):
            self._fail_inflight_locked(rec, work)
            self._cv.notify_all()
            return

        def done(wait):
            self._clock_stop(_OP_NAMES[op], nbytes, start,
                             self._wire_end(_OP_NAMES[op], name, nbytes, 1,
                                            wait=wait))
            out = finish().to(req.tensor.device)
            if wire_op is not None:
                self.timeline.activity_end(name)
            self._complete_locked(req.handle, self.rank, out)
            if self._cuda:
                event = torch.cuda.Event()
                event.record(self._stream)
                self._events[req.handle] = event  # hvdlint: disable=HVD002 -- lock IS held: done() runs as rec.finish under 'with self._cv' in _complete_inflight
            self.timeline.end(name)

        rec.finish = done
        self._launched_locked(rec)

    def _execute_allgather(self, entry):
        """Varying-dim-0 allgather: every rank's block padded to the
        largest dim 0, one all-gather, the real rows sliced back out
        (the reference sizes the output from the negotiated per-rank dims
        and uses MPI_Allgatherv; collective_operations.cc:68-135)."""
        req = entry.requests[self.rank]
        t = req.tensor
        dims0 = (entry.sizes if entry.sizes is not None
                 else [int(t.shape[0])] * self.num_ranks)
        maxd = max(dims0)
        rest = tuple(t.shape[1:])
        wire = _wire(t.dtype)
        holder = {}

        def launch():
            block = torch.zeros((maxd,) + rest, dtype=wire,
                                device=self.device)
            block[:t.shape[0]].copy_(t)
            gathered = torch.empty((self.num_ranks * maxd,) + rest,
                                   dtype=wire, device=self.device)
            holder["g"] = gathered
            # this torch's name for the tiled all-gather (2.13 deprecates
            # all_gather_into_tensor)
            fn = getattr(dist, "all_gather_single", None) \
                or dist.all_gather_into_tensor
            if self._hier_ag is not None:
                return self._hier_allgather(fn, gathered, block)
            return fn(gathered, block, async_op=True)

        def finish():
            g = holder["g"].view((self.num_ranks, maxd) + rest)
            return torch.cat([g[i, :dims0[i]]
                              for i in range(self.num_ranks)]).to(t.dtype)

        nbytes = maxd * math.prod(rest) * t.element_size() \
            * len(self._local_ranks)
        self._single_op(entry, ALLGATHER, tl.XLA_ALLGATHER, nbytes, launch,
                        finish)

    def _execute_broadcast(self, entry):
        """Root's tensor to every rank (reference: MPIBroadcast,
        mpi_operations.cc:396-449); bool travels as uint8."""
        req = entry.requests[self.rank]
        t = req.tensor
        root = req.root_rank
        wire = torch.uint8 if t.dtype == torch.bool else _wire(t.dtype)
        holder = {}

        def launch():
            if self.rank == root:
                buf = t.to(device=self.device, dtype=wire, copy=True)
            else:
                buf = torch.empty(t.shape, dtype=wire, device=self.device)
            holder["b"] = buf
            return dist.broadcast(buf, src=root, async_op=True)

        def finish():
            return holder["b"].to(t.dtype)

        self._single_op(entry, BROADCAST, tl.XLA_BCAST, _nbytes(t), launch,
                        finish)

    def _execute_alltoall(self, entry):
        """Each rank scatters equal dim-0 slices to its peers and gathers
        the slices it receives, in rank order."""
        req = entry.requests[self.rank]
        t = req.tensor
        holder = {}

        def launch():
            x = t.to(self.device, _wire(t.dtype)).contiguous()
            out = torch.empty_like(x)
            holder["o"] = out
            return dist.all_to_all_single(out, x, async_op=True)

        self._single_op(entry, ALLTOALL, None, _nbytes(t), launch,
                        lambda: holder["o"].to(t.dtype))

    def _complete_locked(self, handle, rank, result):
        prev = self._handles.get(handle)
        if isinstance(prev, str):
            self._handles[handle] = {rank: result}
        elif isinstance(prev, dict):
            prev[rank] = result
        self._cv.notify_all()


# The 16-bit integers travel as int32, exact and back: neither gloo nor
# NCCL carries them, and a widened sum cast back wraps as their own does.
_WIDENED = {torch.int16: torch.int32, torch.uint16: torch.int32}


def _wire(dtype):
    """The dtype a collective moves ``dtype``'s values in."""
    return _WIDENED.get(dtype, dtype)


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _DoneWork:
    """The Work of a collective that already ran synchronously."""

    @staticmethod
    def wait():
        return True


_NULL_CTX = _NullCtx()
_DONE = _DoneWork()

