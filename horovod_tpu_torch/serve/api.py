"""Public serving API: ``Engine(model, params)`` with ``submit()`` and
``stream()``, plus the SLO-elasticity signal.

Counterpart of horovod_tpu/serve/api.py: the ownership layer over the
subsystem. It builds the :class:`~horovod_tpu_torch.serve.engine.
ServeEngine` (paged cache + binned prefill/decode) and the
:class:`~horovod_tpu_torch.serve.scheduler.ContinuousBatcher`, drives
the batcher from one background thread, and turns per-request queues
into blocking token iterators.

Elasticity: at a throttled cadence the loop drops a serve signal file
into the elastic policy dir (elastic/policy.py:write_signal), carrying
``queue_depth`` and the sliding-window ``p99_latency`` over per-token
intervals next to the SLO they are judged against.

Knobs (config.py): HOROVOD_SERVE_PAGES, HOROVOD_SERVE_PAGE_SIZE,
HOROVOD_SERVE_MAX_BATCH, HOROVOD_SERVE_QUEUE_DEPTH,
HOROVOD_SERVE_SLO_P99_SECONDS, and HOROVOD_ELASTIC_POLICY_DIR, read from
the environment when the engine is built.
"""

import threading
import time

import numpy as np

from .. import metrics
from ..config import Config
from ..elastic import policy as elastic_policy
from .engine import ServeEngine
from .scheduler import _END, _POLL_S, ContinuousBatcher, Request

DEFAULT_DRAIN_TIMEOUT_S = 120.0
_SIGNAL_INTERVAL_S = 2.0


class Stream:
    """Blocking token iterator over one request's output queue."""

    def __init__(self, request, batcher):
        self.request = request
        self._batcher = batcher

    def __iter__(self):
        while True:
            item = self.request.out_q.get()
            if item is _END:
                return
            yield item[0]

    def result(self):
        """Drain to completion; returns the full generated token list."""
        for _ in self:
            pass
        return list(self.request.generated)

    def cancel(self):
        """Ask the step loop to evict this request; safe from any
        thread. The stream still terminates with its sentinel — up to
        one more token may arrive from the decode step in flight when
        the cancel lands."""
        self._batcher.cancel(self.request)


class Engine:
    """``Engine(model, params)`` — the serving front door.

    ``model`` is a :class:`~horovod_tpu_torch.models.transformer.
    TransformerConfig` (or anything carrying one as ``.cfg``, such as a
    ``TransformerLM``); ``params`` the matching parameter tree on
    ``device`` (default ``cuda``). A keyword left at None takes its
    ``HOROVOD_SERVE_*`` knob from the environment, or the default.
    ``start=False`` skips the background thread: callers then drive
    ``self.batcher.step()`` themselves.

    ``mesh``/``tp_axis`` serve tensor-parallel over a model group
    (serve/engine.py): every rank of the group builds an ``Engine`` with
    the same arguments and submits the same requests in the same order;
    the group's rank 0 leads the schedule (serve/scheduler.py). Its
    ``close()`` ends the other ranks' loops, whose ``close()`` waits for
    that."""

    def __init__(self, model, params, *, mesh=None, tp_axis=None,
                 num_pages=None, page_size=None, max_batch=None,
                 queue_depth=None, policy_dir=None,
                 slo_p99_seconds=None, start=True, **engine_kw):
        cfg = getattr(model, "cfg", model)
        env = Config.from_env()

        def knob(value, attr):
            return getattr(env, attr) if value is None else value

        num_pages = int(knob(num_pages, "serve_pages"))
        page_size = int(knob(page_size, "serve_page_size"))
        max_batch = int(knob(max_batch, "serve_max_batch"))
        queue_depth = int(knob(queue_depth, "serve_queue_depth"))
        self.slo_p99_seconds = float(knob(slo_p99_seconds,
                                          "serve_slo_p99_seconds"))
        self.policy_dir = knob(policy_dir, "elastic_policy_dir")
        self.engine = ServeEngine(params, cfg, mesh=mesh,
                                  tp_axis=tp_axis, num_pages=num_pages,
                                  page_size=page_size, **engine_kw)
        self.batcher = ContinuousBatcher(self.engine,
                                         queue_depth=queue_depth,
                                         max_batch=max_batch)
        self._rank = 0
        self._last_signal_t = 0.0
        self._stop = threading.Event()
        self._thread = None
        self._loop_exc = None
        if start:
            self._thread = threading.Thread(target=self._loop,
                                            name="hvd-serve",
                                            daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- api

    def submit(self, prompt, max_new_tokens=16, *, eos_id=None,
               temperature=0.0, seed=0, timeout=None):
        """Queue a generation request; returns a :class:`Stream`.
        Raises :class:`~horovod_tpu_torch.serve.scheduler.
        ServeOverloaded` when the admission queue is full and
        ``timeout`` ran out (``timeout=0``: immediately)."""
        req = Request(prompt, max_new_tokens, eos_id=eos_id,
                      temperature=temperature, seed=seed)
        self.batcher.submit(req, timeout=timeout)
        return Stream(req, self.batcher)

    def stream(self, handle):
        """Iterate a submitted request's tokens as they decode."""
        return iter(handle)

    def result(self, handle):
        return handle.result()

    def close(self, drain=True, timeout=DEFAULT_DRAIN_TIMEOUT_S):
        """Stop the background loop; by default finish live work
        first. The drain wait is bounded: RuntimeError (chaining the
        loop's exception) if the background thread died with work
        outstanding, TimeoutError after ``timeout`` seconds
        (``timeout=None`` waits forever) — the thread is stopped
        either way instead of hanging the caller. A follower of a
        model group waits for its leader's ``close()``."""
        if self._thread is None:
            if drain:
                self.batcher.drain()
            return
        if not self.batcher.leader:
            self._thread.join(timeout)
            alive = self._thread.is_alive()
            self._stop.set()
            self._thread = None
            if alive:
                raise TimeoutError(
                    f"the model group's leader did not close within "
                    f"{timeout:.0f}s")
            if self._loop_exc is not None:
                raise RuntimeError("hvd-serve loop thread died") \
                    from self._loop_exc
            return
        if drain:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while (self.batcher.active or self.batcher.queue_depth()):
                if not self._thread.is_alive():
                    self._stop.set()
                    self._thread = None
                    raise RuntimeError(
                        "hvd-serve loop thread died with work "
                        "outstanding") from self._loop_exc
                if deadline is not None and time.monotonic() > deadline:
                    self._stop.set()
                    self._thread.join(timeout=10.0)
                    self._thread = None
                    raise TimeoutError(
                        f"serve drain did not complete within "
                        f"{timeout:.0f}s")
                time.sleep(_POLL_S)
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None
        self.batcher.stop_followers()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))

    # ------------------------------------------------------ elasticity

    def p99_latency(self):
        """Sliding-window p99 over per-token decode intervals (falls
        back to TTFT while no token intervals exist yet)."""
        window = (self.batcher.recent_token_latency
                  or self.batcher.recent_ttft)
        if not window:
            return 0.0
        return float(np.percentile(np.asarray(window), 99))

    def slo_signal(self):
        """The elasticity payload this engine exports — queue depth and
        p99 next to the SLO they are judged against."""
        return {
            "role": "serve",
            "time": time.time(),
            "queue_depth": self.batcher.queue_depth(),
            "active": self.batcher.active,
            "p99_latency": self.p99_latency(),
            "slo_p99_seconds": self.slo_p99_seconds,
        }

    def write_slo_signal(self):
        """Drop the signal file for the supervisor-side policy (no-op
        without a policy dir)."""
        sig = self.slo_signal()
        metrics.SERVE_P99_LATENCY_SECONDS.set(sig["p99_latency"])
        if self.policy_dir:
            elastic_policy.write_signal(self.policy_dir,
                                        f"serve{self._rank}", sig)
        return sig

    # ------------------------------------------------------------ loop

    def _loop(self):
        try:
            while not self._stop.is_set() and not self.batcher.stopped:
                did_work = self.batcher.step()
                now = time.monotonic()
                if now - self._last_signal_t >= _SIGNAL_INTERVAL_S:
                    self._last_signal_t = now
                    self.write_slo_signal()
                if not did_work and self.batcher.leader:
                    self._stop.wait(_POLL_S)
        except BaseException as exc:
            self._loop_exc = exc  # close() chains it for the caller
            raise
