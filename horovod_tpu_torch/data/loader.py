"""DistributedDataset: sharded, prefetched, elastic-resumable input.

Counterpart of horovod_tpu/data/loader.py. One object owns the three
concerns every example used to hand-roll:

- **sharding**: a deterministic per-epoch global shuffle and this rank's
  equal-steps slice of it (sharding.py, the JAX package's index math
  sample for sample); every rank takes the same number of batches per
  epoch, so a collective-per-step loop can never be wedged by a peer
  that ran dry early;
- **staging**: a background producer thread gathers each batch on the
  host, copies it into pinned memory and starts its copy to the card
  with ``non_blocking=True`` on a stream of its own, recording an event
  after it. Up to ``HOROVOD_DATA_PREFETCH`` batches (default 2) are in
  flight; the consumer's stream waits on the batch's event (no host
  synchronisation) and the batch's tensors are recorded on that stream
  for the caching allocator. The port captures its graphs in
  ``thread_local`` mode, so the producer's pinned allocations and copies
  may run while the loop's thread captures a step
  (tests/test_torch_cuda_graphs.py holds them to it on the card). ``0``
  is the synchronous path: the batch
  is built and copied inline when the loop asks for it. On the CPU
  (``device="cpu"``) batches stay host tensors;
- **resumable position**: ``state_dict()``/``load_state_dict()``
  round-trip the iterator position (epoch, seed, segment history,
  state.py); committed into an ``elastic.State``
  (:func:`~horovod_tpu_torch.data.attach_to_state`), a SIGKILL recovery
  resumes mid-epoch without duplicating or dropping samples, and
  re-shards the unconsumed remainder across the survivors.

Telemetry: the ``hvd_data_*`` families (batches, samples, epochs,
re-shards, the input-wait histogram, the prefetch depth and queue
occupancy). Under ``HOROVOD_AUTOTUNE`` the loader feeds the session's
tuner the depth each epoch runs at and every input wait, and the tuner's
prefetch hill-climb changes ``data_prefetch``, which the next epoch
reads.

Usage::

    ds = hvd.data.DistributedDataset(tokens, batch_size=4, seed=1234,
                                     transform=split_inputs_and_targets)
    for epoch in range(epochs):
        for x, y in ds:                  # one epoch per for-loop
            loss = step(x, y)
"""

import contextlib
import queue
import threading
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import diag, metrics
from ..utils.devices import resolve_device
from ..utils.logging import get_logger
from . import sharding as sharding_mod
from .state import IteratorState, rebuild_plan

_logger = get_logger()

# Producer-side put poll quantum: bounds how long a stale producer can
# outlive an invalidation, without busy-waiting.
_POLL_S = 0.05

_END = object()


def _env_prefetch():
    from ..config import Config
    return Config.from_env().data_prefetch


def process_topology():
    """``(rank, size)`` of this process in the current job: the input
    topology (a process stages batches for its card). It follows
    elastic membership: after a recovery the survivors renumber densely
    (``init(comm=...)``). ``(0, 1)`` outside an initialized job."""
    from .. import runtime
    if runtime.is_initialized():
        return runtime.rank(), runtime.size()
    return 0, 1


def _as_tensor(a):
    if torch.is_tensor(a):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class _Staged:
    """A batch whose copy to the card is in flight on the producer's
    stream; ``event`` fires when it has landed."""

    __slots__ = ("batch", "event")

    def __init__(self, batch, event):
        self.batch = batch
        self.event = event


class DistributedDataset:
    """Deterministically sharded, background-prefetched batch iterator.

    Args:
      source: the samples: a pytree (dict, list, tuple) of equal-length
        arrays or tensors indexed on axis 0 (batches are pytrees of the
        same structure), or a callable ``fetch(indices) -> batch`` for
        out-of-core sources (``num_samples`` is then required).
      batch_size: samples per batch staged by this process (the global
        batch is ``batch_size * size``).
      num_samples: dataset length; inferred from array sources.
      seed: base seed of the per-epoch global shuffle.
      shuffle: reshuffle globally each epoch.
      policy: ``"contiguous"`` or ``"strided"`` rank slicing.
      remainder: ``"pad"`` or ``"drop"`` (sharding.py).
      rank, size: sharding topology; default :func:`process_topology`.
      prefetch: queue depth; ``0`` = synchronous. Default: the live
        ``HOROVOD_DATA_PREFETCH`` config, re-read each epoch.
      device: where batches land: ``"cuda"`` (default; through pinned
        memory and non-blocking copies on a side stream) or ``"cpu"``
        (host tensors).
      transform: optional ``fn(batch) -> batch`` applied on the host, on
        the producer thread, before staging.
    """

    def __init__(self, source, batch_size, num_samples=None, seed=0,
                 shuffle=True, policy="contiguous", remainder="pad",
                 rank=None, size=None, prefetch=None, device="cuda",
                 transform=None):
        if callable(source):
            if num_samples is None:
                raise ValueError(
                    "callable sources need num_samples= (an array source "
                    "infers it from the leaves)")
            self._fetch = source
            self._num_samples = int(num_samples)
        else:
            leaves = pytree.tree_leaves(source)
            if not leaves:
                raise ValueError("source pytree has no array leaves")
            lens = {len(x) for x in leaves}
            if len(lens) != 1:
                raise ValueError(
                    f"source leaves disagree on length: {sorted(lens)}")
            n = lens.pop()
            if num_samples is not None and int(num_samples) != n:
                raise ValueError(
                    f"num_samples={num_samples} != source length {n}")
            self._source = pytree.tree_map(_as_tensor, source)
            self._fetch = self._fetch_arrays
            self._num_samples = n
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive: {batch_size}")
        self.batch_size = int(batch_size)
        self.policy = policy
        self.remainder = remainder
        self._explicit_rank = rank
        self._explicit_size = size
        self._explicit_prefetch = prefetch
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._transform = transform

        self._state = IteratorState(epoch=0, seed=int(seed), shuffle=shuffle)
        self.rank, self.size = self._resolve_topology()
        self._state.begin_epoch(0, self.size)
        self._plan, self._step, _ = rebuild_plan(
            self._num_samples, self._state, self.rank, self.size,
            self.batch_size, policy, remainder)

        self._wait_accum = 0.0
        self._gen = 0
        self._producer = None     # (thread, queue, stop_event, gen)

    # ------------------------------------------------------------ sources

    def _fetch_arrays(self, indices):
        idx = torch.from_numpy(np.asarray(indices, dtype=np.int64))
        return pytree.tree_map(lambda a: a.index_select(0, idx),
                               self._source)

    # ----------------------------------------------------------- topology

    def _resolve_topology(self):
        if self._explicit_rank is not None or self._explicit_size is not None:
            if self._explicit_rank is None or self._explicit_size is None:
                raise ValueError("pass rank= and size= together")
            r, s = int(self._explicit_rank), int(self._explicit_size)
        else:
            r, s = process_topology()
        if not 0 <= r < s:
            raise ValueError(f"rank {r} out of range for size {s}")
        return r, s

    def _resolve_prefetch(self):
        if self._explicit_prefetch is not None:
            return max(int(self._explicit_prefetch), 0)
        from .. import runtime
        if runtime.is_initialized():
            return max(int(runtime.live_state().config.data_prefetch), 0)
        return _env_prefetch()

    def _autotuner(self):
        """The session's autotuner (autotune.py), or None: no session, no
        ``HOROVOD_AUTOTUNE``, or a process that is not process 0."""
        from .. import runtime
        if runtime.is_initialized():
            return runtime.live_state().autotuner
        return None

    # ----------------------------------------------------------- position

    @property
    def epoch(self):
        return self._state.epoch

    @property
    def num_samples(self):
        return self._num_samples

    @property
    def steps_per_epoch(self):
        """Steps in a FRESH epoch at the current topology (a job-wide
        constant: the equal-steps invariant)."""
        return sharding_mod.steps_for(self._num_samples, self.size,
                                      self.batch_size, self.remainder)

    @property
    def steps_remaining(self):
        """Batches left in the current (possibly re-sharded) epoch."""
        return len(self._plan) // self.batch_size - self._step

    def state_dict(self):
        """The committed-position codec: a dict of small ints (epoch,
        seed, segment history; data/state.py)."""
        return self._state.to_dict()

    def load_state_dict(self, sd):
        """Rewind to a captured position. Reads the CURRENT topology, so
        a load after a membership change re-shards the epoch's
        unconsumed remainder across the survivors (counted by
        ``hvd_data_reshards_total``). Prefetched batches from the
        abandoned position are discarded."""
        self._invalidate()
        self._state = IteratorState.from_dict(sd)
        self.rank, self.size = self._resolve_topology()
        self._plan, self._step, resharded = rebuild_plan(
            self._num_samples, self._state, self.rank, self.size,
            self.batch_size, self.policy, self.remainder)
        if resharded:
            metrics.DATA_RESHARDS.inc()
            _logger.warning(
                "data: re-sharded epoch %d remainder across %d rank(s) "
                "(%d step(s) left on this rank)", self._state.epoch,
                self.size, self.steps_remaining)

    # ---------------------------------------------------------- iteration

    def __iter__(self):
        """Yield the REMAINING batches of the current epoch, then advance
        to the next epoch (fresh permutation, full topology). One epoch
        per for-loop; a loop entered after ``load_state_dict`` continues
        mid-epoch."""
        return self._iterate_epoch()

    def __len__(self):
        return self.steps_remaining

    def _iterate_epoch(self):
        depth = self._resolve_prefetch()
        metrics.DATA_PREFETCH_DEPTH.set(depth)
        tuner = self._autotuner()
        if tuner is not None:
            # the depth this epoch actually runs at: the tuner must not
            # step again off measurements taken before its last change
            # landed (a depth applies at an epoch's start)
            tuner.record_prefetch_depth(depth)
        steps_left = self.steps_remaining
        if depth > 0 and steps_left > 0:
            self._start_producer(depth)
        for _ in range(steps_left):
            t0 = time.perf_counter()
            if depth > 0 and self._producer is not None:
                batch = self._get_prefetched()
            else:
                batch = self._land(self._produce(self._plan, self._step,
                                                 None))
            self._record_wait(time.perf_counter() - t0, tuner)
            self._step += 1
            self._state.segments[-1][1] = self._step
            metrics.DATA_BATCHES.inc()
            metrics.DATA_SAMPLES.inc(self.batch_size)
            yield batch
            if self._step >= len(self._plan) // self.batch_size:
                break  # position moved under us (load_state_dict mid-loop)
        if self.steps_remaining <= 0:
            self._advance_epoch()

    def _advance_epoch(self):
        self._invalidate()
        self.rank, self.size = self._resolve_topology()
        self._state.begin_epoch(self._state.epoch + 1, self.size)
        self._plan, self._step, _ = rebuild_plan(
            self._num_samples, self._state, self.rank, self.size,
            self.batch_size, self.policy, self.remainder)
        metrics.DATA_EPOCHS.inc()

    def _produce(self, plan, step, stream):
        """Batch ``step`` of ``plan``: gathered on the host, transformed,
        and on a card pinned and copied with ``non_blocking=True`` on
        ``stream`` (the current stream when None). Returns a
        :class:`_Staged` on a card, the host batch otherwise."""
        idx = plan[step * self.batch_size:(step + 1) * self.batch_size]
        batch = self._fetch(idx)
        if self._transform is not None:
            batch = self._transform(batch)
        batch = pytree.tree_map(_as_tensor, batch)
        if not self._cuda:
            return batch
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            pinned = pytree.tree_map(lambda t: t.pin_memory(), batch)
            staged = pytree.tree_map(
                lambda t: t.to(self.device, non_blocking=True), pinned)
            event = torch.cuda.Event()
            event.record()
        return _Staged(staged, event)

    def _land(self, item):
        """A staged batch, ordered on the consumer's current stream."""
        if not isinstance(item, _Staged):
            return item
        current = torch.cuda.current_stream(self.device)
        current.wait_event(item.event)
        for t in pytree.tree_leaves(item.batch):
            t.record_stream(current)
        return item.batch

    def _record_wait(self, wait, tuner=None):
        metrics.DATA_WAIT_SECONDS.observe(wait)
        self._wait_accum += wait
        fr = diag.get()
        if fr is not None:
            fr.record("input_wait", extra={"wait": wait})
        if tuner is not None:
            tuner.record_input_wait(wait)

    def take_wait(self):
        """Input-wait seconds accumulated since the last call: how long
        the loop blocked on batches (TelemetryCallback turns this into
        ``hvd_data_stall_ratio``)."""
        w = self._wait_accum
        self._wait_accum = 0.0
        return w

    def prefetch_occupancy(self):
        """Current prefetch-queue fill fraction (0.0-1.0), or None when
        prefetch is off: the autoscaler's compute-bound signal."""
        if self._producer is None:
            return None
        _t, q, _stop, _gen = self._producer
        depth = q.maxsize or 1
        return min(q.qsize() / depth, 1.0)

    # ----------------------------------------------------------- prefetch

    def _start_producer(self, depth):
        self._invalidate()
        q = queue.Queue(maxsize=depth)
        stop = threading.Event()
        gen = self._gen
        plan, start = self._plan, self._step
        steps = len(plan) // self.batch_size
        stream = torch.cuda.Stream(self.device) if self._cuda else None

        def put(item):
            # a full queue delays an item, never drops it (a dropped one
            # would leave the consumer blocked in q.get() forever)
            while not stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for step in range(start, steps):
                    if stop.is_set() or not put(
                            self._produce(plan, step, stream)):
                        return
                put(_END)
            except BaseException as e:  # noqa: BLE001 — surface on consumer
                put(e)

        t = threading.Thread(target=produce, daemon=True,
                             name=f"hvd-data-prefetch-{gen}")
        t.start()
        self._producer = (t, q, stop, gen)

    def _get_prefetched(self):
        t, q, stop, gen = self._producer
        metrics.DATA_PREFETCH_OCCUPANCY.observe(q.qsize())
        item = q.get()
        if item is _END:
            raise RuntimeError(
                "prefetch producer ended before the plan did (dataset "
                "mutated mid-epoch without load_state_dict?)")
        if isinstance(item, BaseException):
            raise item
        return self._land(item)

    def _invalidate(self):
        """Retire the current producer (position change / epoch end).
        The thread observes its stop event within one poll quantum; its
        queue is dropped whole, so stale batches can't leak into the new
        position."""
        if self._producer is not None:
            t, q, stop, gen = self._producer
            stop.set()
            self._producer = None
            t.join(timeout=5.0)
        self._gen += 1

    def close(self):
        """Stop the background producer. Idempotent; iteration after
        close() restarts it."""
        self._invalidate()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

