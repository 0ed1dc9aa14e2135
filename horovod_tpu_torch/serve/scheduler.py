"""Iteration-level continuous batching (Orca-style) over the serve
engine.

Counterpart of horovod_tpu/serve/scheduler.py, whole. The scheduling
unit is ONE decode iteration: between any two decode steps the batch may
admit waiting requests (join) and retire finished ones (evict). Admission
is a bounded queue (``queue.Queue`` + poll interval + sentinel); a full
queue pushes back on the caller instead of buffering without bound, and
queue depth is the first elasticity signal (serve/api.py).

Capacity is governed by free KV pages alone: a request joins only when
the paged cache can reserve its WHOLE lifetime (prompt + max new tokens,
rounded up to pages), so a running sequence never runs out of pages
mid-stream and eviction is exactly completion (EOS, token budget or
cancel). Joins prefill together in one engine call; every active
sequence then advances one token per :meth:`ContinuousBatcher.step`.

Determinism: joins are processed in FIFO order, sampling is greedy at
temperature 0 and seeded per request above it, and the engine's math is
row-independent, so with pinned shape-bin floors a sequence's token
stream is the same whether it runs alone or among other sequences.
"""

import collections
import itertools
import queue
import threading
import time

import numpy as np

from .. import metrics

_POLL_S = 0.05  # admission-queue poll interval
_END = object()  # per-stream terminator sentinel


class ServeOverloaded(RuntimeError):
    """Admission queue full: the caller should retry later (or the
    deployment should scale up — queue depth feeds the autoscaler)."""


class Request:
    """One generation request + its live stream state. ``out_q`` holds
    ``(token, wall_time)`` pairs and terminates with the ``_END``
    sentinel; serve/api.py wraps it into the streaming iterator."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, eos_id=None,
                 temperature=0.0, seed=0):
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.rid = next(Request._ids)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self._rng = np.random.default_rng(seed)
        self.out_q = queue.Queue()
        self.generated = []
        self.submitted_t = time.perf_counter()
        self.first_token_t = None
        self.last_token_t = None
        self.finished = False

    @property
    def length(self):
        """Visible cache rows: prompt + generated tokens so far."""
        return len(self.prompt) + len(self.generated)

    def select(self, logits):
        """Next token from a (V,) f32 logits row — greedy at
        temperature <= 0, seeded softmax sample above."""
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / self.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))


class ContinuousBatcher:
    """Join/evict-per-iteration scheduler over a ServeEngine.

    ``step()`` is the whole loop body and is meant to be driven by one
    thread (serve/api.py's background loop, or a test directly);
    ``submit()`` and ``cancel()`` are the thread-safe entries (the
    admission queue and the cancel-mark set are the only cross-thread
    structures — a cancel never mutates ``_active`` or the page pool
    inline; the step thread applies it at its next iteration)."""

    def __init__(self, engine, queue_depth=64, max_batch=None):
        from .engine import DEFAULT_MAX_BATCH
        self.engine = engine
        self.max_batch = int(max_batch or DEFAULT_MAX_BATCH)
        self._admit = queue.Queue(maxsize=int(queue_depth))
        self._pending = None   # popped but not yet admitted (no pages)
        self._active = {}      # seq id (rid) -> Request, join order
        self._cancel_lock = threading.Lock()
        self._cancel_marks = set()  # Requests cancel() marked for evict
        self.steps = 0
        # Raw sliding windows behind the histograms — the SLO/elasticity
        # p99 (serve/api.py) needs quantiles, which counters can't give.
        self.recent_ttft = collections.deque(maxlen=256)
        self.recent_token_latency = collections.deque(maxlen=1024)

    # ------------------------------------------------------- admission

    def submit(self, request, timeout=None):
        """Enqueue a request. ``timeout=None`` blocks until the queue
        drains; ``timeout=0`` raises :class:`ServeOverloaded`
        immediately when full (the backpressure contract). A request
        whose whole-lifetime reservation (prompt + max new tokens)
        could NEVER be allocated — wider than ``max_pages_per_seq`` or
        than the pool itself — is rejected here with ValueError:
        admission is FIFO with no overtaking, so parking it would
        wedge the engine forever."""
        cache = self.engine.cache
        need = cache.pages_for(len(request.prompt)
                               + request.max_new_tokens)
        cap = min(cache.max_pages_per_seq, cache.num_pages - 1)
        if need > cap:
            metrics.SERVE_REQUESTS.labels(outcome="rejected").inc()
            raise ValueError(
                f"request lifetime (prompt {len(request.prompt)} + "
                f"max_new_tokens {request.max_new_tokens}) needs "
                f"{need} KV pages but this engine can never free more "
                f"than {cap} (max_pages_per_seq="
                f"{cache.max_pages_per_seq}, allocatable pages="
                f"{cache.num_pages - 1})")
        try:
            if timeout is None:
                self._admit.put(request)
            else:
                self._admit.put(request, timeout=timeout)
        except queue.Full:
            metrics.SERVE_REQUESTS.labels(outcome="rejected").inc()
            raise ServeOverloaded(
                f"admission queue full ({self._admit.maxsize})") from None
        metrics.SERVE_REQUESTS.labels(outcome="admitted").inc()
        metrics.SERVE_QUEUE_DEPTH.set(self.queue_depth())
        return request

    def queue_depth(self):
        depth = self._admit.qsize()
        return depth + (1 if self._pending is not None else 0)

    @property
    def active(self):
        return len(self._active)

    # ----------------------------------------------------------- steps

    def _take_joins(self):
        """FIFO-pop waiting requests while the batch has a slot AND the
        page pool covers the request's whole lifetime. The first
        request that doesn't fit stalls admission (no overtaking — a
        small request must not starve a big one forever)."""
        joins = []
        cache = self.engine.cache
        while len(self._active) + len(joins) < self.max_batch:
            req = self._pending
            self._pending = None
            if req is None:
                try:
                    req = self._admit.get_nowait()
                except queue.Empty:
                    break
            if self._claim_cancel(req):
                self._finish_unjoined(req)
                continue
            if not cache.can_allocate(len(req.prompt)
                                      + req.max_new_tokens):
                self._pending = req
                break
            cache.allocate(req.rid, len(req.prompt)
                           + req.max_new_tokens)
            joins.append(req)
        return joins

    def _emit(self, req, token):
        now = time.perf_counter()
        req.generated.append(token)
        if req.first_token_t is None:
            req.first_token_t = now
            metrics.SERVE_TTFT_SECONDS.observe(now - req.submitted_t)
            self.recent_ttft.append(now - req.submitted_t)
        else:
            metrics.SERVE_TOKEN_LATENCY_SECONDS.observe(
                now - req.last_token_t)
            self.recent_token_latency.append(now - req.last_token_t)
        req.last_token_t = now
        req.out_q.put((token, now))
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and token == req.eos_id)):
            self._evict(req, "eos" if (req.eos_id is not None
                                       and token == req.eos_id)
                        else "finished")

    def _evict(self, req, reason):
        req.finished = True
        self._active.pop(req.rid, None)
        self.engine.cache.free(req.rid)
        with self._cancel_lock:
            self._cancel_marks.discard(req)
        req.out_q.put(_END)
        metrics.SERVE_EVICTIONS.labels(reason=reason).inc()
        metrics.SERVE_REQUESTS.labels(outcome="completed").inc()

    def cancel(self, req):
        """Mark a request for eviction (client went away). Thread-safe:
        the step thread applies the mark at the start of its next
        iteration. Evicting inline from another thread would race an
        in-flight ``step()`` — freed pages could KeyError its page-table
        snapshot or be re-allocated to a joiner while the old
        sequence's K/V row is still being scattered into them."""
        if req.finished:
            return
        with self._cancel_lock:
            self._cancel_marks.add(req)

    def _claim_cancel(self, req):
        """Pop ``req``'s cancel mark if present (step thread only)."""
        with self._cancel_lock:
            if req in self._cancel_marks:
                self._cancel_marks.discard(req)
                return True
        return False

    def _finish_unjoined(self, req):
        """Terminate a cancelled request that never joined — it holds
        no pages and was never in ``_active``, only its stream needs
        closing."""
        req.finished = True
        req.out_q.put(_END)
        metrics.SERVE_EVICTIONS.labels(reason="cancelled").inc()
        metrics.SERVE_REQUESTS.labels(outcome="completed").inc()

    def _apply_cancels(self):
        """Step-thread only: evict every marked request that is live.
        Marks for requests still waiting in the admission queue stay
        set until :meth:`_take_joins` surfaces them; marks that raced a
        natural finish are dropped."""
        with self._cancel_lock:
            marked = [r for r in self._cancel_marks
                      if r.rid in self._active or r.finished]
            self._cancel_marks.difference_update(marked)
        for req in marked:
            if not req.finished:
                self._evict(req, "cancelled")

    def step(self):
        """One continuous-batching iteration: apply cross-thread
        cancellations, join waiting requests (one shared prefill call →
        each joiner's FIRST token), then one decode step for every
        active sequence. Returns True when any work happened."""
        self._apply_cancels()
        joins = self._take_joins()
        if joins:
            metrics.SERVE_JOINS.inc(len(joins))
            logits = self.engine.prefill([r.rid for r in joins],
                                         [r.prompt for r in joins])
            for i, req in enumerate(joins):
                self._active[req.rid] = req
                self._emit(req, req.select(logits[i]))
        live = list(self._active.values())
        if live:
            # lengths = rows already cached = the fed token's position
            # (the engine scatters the token's K/V row there and
            # attends over lengths + 1 visible positions).
            logits = self.engine.decode(
                [r.rid for r in live],
                [r.generated[-1] for r in live],
                [r.length - 1 for r in live])
            for i, req in enumerate(live):
                self._emit(req, req.select(logits[i]))
        self.steps += 1
        metrics.SERVE_QUEUE_DEPTH.set(self.queue_depth())
        self.engine.update_pool_metrics()
        return bool(joins or live)

    def drain(self):
        """Step until every admitted request has finished."""
        while self.step() or self.queue_depth():
            pass

    # ------------------------------------------------------- loop glue

    def run(self, stop_event: threading.Event):
        """Drive steps until ``stop_event``; idle-polls on the loader
        cadence when there is nothing to do."""
        while not stop_event.is_set():
            if not self.step():
                stop_event.wait(_POLL_S)
