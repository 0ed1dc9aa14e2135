"""Compiled hot loop: one captured CUDA graph a training step.

Counterpart of horovod_tpu/ops/step_program.py, whose
``CompiledTrainStep`` runs forward, backward, the fused gradient
exchange and the optimizer's update as one jitted, buffer-donated XLA
program, cached by signature, with counted fallbacks to the eager step.
On a card the counterpart of that program is a CUDA graph:

- the first call of a signature runs the step eagerly on a side stream
  (the warm-up: it fills the optimizer's state, the exchange's buffers,
  NCCL's communicator and every lazily loaded kernel), and returns that
  step's loss;
- then it captures the same step into a ``torch.cuda.CUDAGraph`` in the
  session's shared memory pool (``runtime.ProgramCache.graph_pool``):
  the forward with its hand kernels, the backward, the bucket
  all-reduces the gradient hooks launch, and ``optimizer.step()``;
- every later call copies the batch into the graph's static inputs and
  replays it.

A replay runs no host code, which the program makes up for: the kernel
launches its capture counted are taken back off the counters and added
on every replay (ops/flash_attention.py), and the collectives it
captured are recorded once, as ``allreduce_jit``, and again on every
replay only under ``HOROVOD_PROFILER_JIT_CALLBACKS=1`` (stats.py), as
the JAX package records a jitted collective once per trace.

On the CPU nothing is captured (gloo is not capturable and the CPU has no
graphs): a program is its step function run as it is, under the same
signatures, cache counters and fallback reasons, as the JAX package
compiles for the CPU. On a card a capture that fails raises; nothing
runs eagerly in its place.
"""

import itertools
import weakref

import torch

from .. import metrics, runtime
from ..config import Config, step_program_enabled
from ..stats import replay_jit
from . import flash_attention as fa
from .collectives import exchange_bucket_plan, grouped_allreduce

__all__ = ["CompiledTrainStep", "StepProgram", "compiled_train_step",
           "engine_cached_program"]

_token_registry = weakref.WeakKeyDictionary()
_token_counter = itertools.count()


def obj_token(obj):
    """Process-unique token for a live object: the same object gives the
    same token, two live objects two tokens. Weak, so dropping the last
    reference to a loss function or an optimizer drops its token."""
    try:
        tok = _token_registry.get(obj)
        if tok is None:
            tok = _token_registry[obj] = next(_token_counter)
        return tok
    except TypeError:  # not weakly referenceable
        return id(obj)


class StepProgram:
    """``fn()``, whose tensors are static (allocated before the first
    call and kept), run as a program: on a card a CUDA graph captured
    from it, on the CPU, or with the compiled hot loop off
    (``HOROVOD_STEP_PROGRAM=0`` or ``HOROVOD_DEVICE_RESIDENT=0``),
    ``fn`` itself.

    The first call on a card runs ``fn`` on a side stream and returns
    its result (the warm-up is the call's own work), then captures
    ``fn`` into a graph in ``pool`` (None: a pool of the graph's own).
    Each later call replays the graph and returns the output of the
    capture, a static tensor. Programs sharing a pool replay one at a
    time on one stream and treat what they allocated in it as scratch:
    the next replay of any of them may overwrite this output, so a
    caller that keeps it copies it first."""

    def __init__(self, fn, device, pool=None, inputs=()):
        self._fn = fn
        self.inputs = list(inputs)  # the static tensors a caller fills
        self._device = torch.device(device)
        self._pool = pool
        self._graph = None
        self._out = None
        self.launches = {}     # kernel launches of one replay, by counter
        self.collectives = []  # (op, nbytes) a replay records
        cfg = Config.from_env()
        self._capture = (self._device.type == "cuda"
                         and step_program_enabled(cfg))
        self._callbacks = cfg.profiler_jit_callbacks

    @property
    def captured(self):
        return self._graph is not None

    def __call__(self):
        if not self._capture:
            return self._fn()
        if self._graph is None:
            return self._warm_up_and_capture()
        self._graph.replay()
        fa.count_replay(self.launches)
        if self._callbacks:
            replay_jit(self.collectives)
        return self._out

    def _warm_up_and_capture(self):
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._fn()
        current.wait_stream(side)
        stats = (runtime.live_state().stats if runtime.is_initialized()
                 else None)
        jit0 = stats.jit_records() if stats is not None else {}
        launches0 = fa.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # thread_local: NCCL's watchdog and the serve loop's neighbours
        # may call the CUDA API from other threads meanwhile.
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            self._out = self._fn()
        self.launches = fa.uncount_capture(launches0)
        if stats is not None:
            for (op, nbytes), n in stats.jit_records().items():
                self.collectives += [(op, nbytes)] * (n - jit0.get(
                    (op, nbytes), 0))
        self._graph = graph
        return out


def engine_cached_program(signature, build):
    """``(program, was_hit)`` from the session's signature-keyed program
    cache (runtime.ProgramCache): the cache tier's entry for callers
    outside the train step. The serve engine and ``generate`` route
    their programs here, so they share its hit and miss counts, its
    graph memory pool and its cold start at ``shutdown()``."""
    return runtime.live_state().programs.get(signature, build)


def _hyperparameters(optimizer):
    """The optimizer's scalar hyperparameters, group by group: a captured
    update bakes them in, so a changed one is a new signature (a tensor
    one is read from the card on every replay, and not keyed)."""
    return tuple(tuple(sorted((k, v) for k, v in g.items()
                              if isinstance(v, (bool, int, float, str,
                                                tuple, type(None)))))
                 for g in optimizer.param_groups)


class CompiledTrainStep:
    """The compiled training step::

        model = tfm.TransformerLM(cfg, device="cuda")
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), capturable=True),
            named_parameters=model.named_parameters())
        step = hvd.compiled_train_step(model.loss, opt)
        for tokens, targets in data:
            loss = step(tokens, targets)
        step.finish()

    ``loss_fn(*batch)`` returns the mean loss of the batch, computed
    from the parameters the optimizer holds; ``step(*batch)`` runs it,
    its backward, the gradient exchange and ``optimizer.step()``, which
    updates those parameters in place (the counterpart of the JAX
    package's donated buffers: nothing is returned but the loss), and
    returns the loss as a device scalar it does not fetch. On a card
    the optimizer must keep its step count on the device
    (``capturable=True``), and the gradients live in the graph's pool:
    read them before another program replays.

    The exchange: a ``DistributedOptimizer`` exchanges through its
    gradient hooks, whose bucket all-reduces the graph captures
    (``exchange_buckets`` re-plans its buckets); a plain optimizer gets
    one fused all-reduce a bucket in front of its update (the JAX
    package's auto decomposition). The ZeRO, sharding-spec and MoE
    layouts raise ``NotImplementedError`` naming their ROADMAP.md items
    where ``DistributedOptimizer`` is built, and the guard here.

    Fallback (``hvd_step_fallback_total`` by reason): the eager step
    runs instead under ``HOROVOD_STEP_PROGRAM=0`` (``disabled``),
    ``HOROVOD_DEVICE_RESIDENT=0`` (``host_mode``), or for a signature
    past ``HOROVOD_STEP_PROGRAM_CHURN_LIMIT`` (``shape_churn``)."""

    def __init__(self, loss_fn, optimizer, *, name="hvd.step",
                 exchange_buckets=None):
        if Config.from_env().guard:
            raise NotImplementedError(
                "HOROVOD_GUARD is set, but the step-integrity guard "
                "(ROADMAP.md, Queue 1 item 15) is not ported yet")
        hooks = getattr(optimizer, "_hvd_exchange", None) == "hooks"
        if hooks and optimizer.backward_passes_per_step > 1:
            raise ValueError(
                "compiled_train_step cannot introspect "
                "DistributedOptimizer(backward_passes_per_step>1); "
                "compile the inner step and accumulate outside")
        if hooks and exchange_buckets is not None:
            optimizer.plan_exchange(exchange_buckets)
        self.name = name
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._buckets = exchange_buckets
        self._exchange = "hooks" if hooks else "psum"
        self._params = [p for g in optimizer.param_groups
                        for p in g["params"] if p.requires_grad]
        self._layout = tuple((tuple(p.shape), str(p.dtype), str(p.device))
                             for p in self._params)
        self._programs = None
        self._signatures = set()
        self.cache_hits = 0
        self.cache_misses = 0
        self.compiled_steps = 0
        self.fallback_steps = 0

    @property
    def cache_hit_rate(self):
        """This step object's program cache hit rate over its life."""
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def finish(self):
        """Call once after the loop. The JAX package returns the guard's
        deferred verdict here; the guard is not ported (ROADMAP.md,
        Queue 1 item 15), so there is none: returns None."""
        return None

    # ------------------------------------------------------------ the step

    def _bucket_count(self, cfg):
        if self._exchange == "hooks":
            return len(self._optimizer.exchange_buckets)
        return max(int(self._buckets if self._buckets is not None
                       else cfg.exchange_buckets), 1)

    def _psum(self, buckets):
        """The fused exchange in front of a plain optimizer: per bucket,
        one all-reduce a dtype, averaged, copied back into the
        gradients."""
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for idx in exchange_bucket_plan(self._params, buckets):
            grads = [self._params[i].grad for i in idx]
            for g, avg in zip(grads, grouped_allreduce(grads)):
                g.copy_(avg)

    def _step(self, batch, buckets):
        """One eager step on ``batch``. In a capture the first line runs
        on the host only: the graph's backward then allocates the
        gradients in its pool, and each replay writes them afresh."""
        self._optimizer.zero_grad(set_to_none=True)
        loss = self._loss_fn(*batch)
        loss.backward()
        if self._exchange == "psum":
            self._psum(buckets)
        self._optimizer.step()
        return loss.detach()

    def _signature(self, device, batch, buckets):
        return ("step_program", self._exchange, buckets,
                obj_token(self._optimizer), obj_token(self._loss_fn),
                self._layout, _hyperparameters(self._optimizer),
                tuple((tuple(x.shape), str(x.dtype), str(x.device))
                      for x in batch), str(device))

    def _build(self, st, batch, buckets):
        device = st.device
        if device.type == "cuda":
            for g in self._optimizer.param_groups:
                if g.get("capturable") is False:
                    raise ValueError(
                        "compiled_train_step on a card needs an optimizer "
                        "built with capturable=True (its step count must "
                        "live on the card for the graph to advance it)")
        inputs = [torch.empty_like(x, device=device) for x in batch]
        pool = (st.programs.graph_pool() if device.type == "cuda"
                else None)
        return StepProgram(lambda: self._step(inputs, buckets), device,
                           pool, inputs)

    def __call__(self, *batch):
        st = runtime.live_state()
        if st.programs is not self._programs:
            # a new session: its cache is cold, and so are the
            # signatures this object saw in the old one
            self._programs = st.programs
            self._signatures = set()
        cfg = st.config
        buckets = self._bucket_count(cfg)
        if not step_program_enabled(cfg):
            reason = "disabled" if cfg.step_program == 0 else "host_mode"
            return self._fallback(reason, batch, buckets)
        sig = self._signature(st.device, batch, buckets)
        if sig not in self._signatures:
            if len(self._signatures) >= cfg.step_program_churn_limit:
                return self._fallback("shape_churn", batch, buckets)
            self._signatures.add(sig)
        prog, was_hit = st.programs.get(
            sig, lambda: self._build(st, batch, buckets))
        if was_hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        metrics.STEP_PROGRAM_CACHE_HITS.set(st.programs.hits)
        metrics.STEP_PROGRAM_CACHE_MISSES.set(st.programs.misses)
        for dst, src in zip(prog.inputs, batch):
            dst.copy_(src)
        captured = prog.captured
        loss = prog()
        metrics.STEP_COMPILED_TOTAL.inc()
        self.compiled_steps += 1
        # a replay's loss is the graph's static output: keep a copy
        return loss.clone() if captured else loss

    def _fallback(self, reason, batch, buckets):
        metrics.STEP_FALLBACK_TOTAL.labels(reason=reason).inc()
        self.fallback_steps += 1
        return self._step(batch, buckets)


def compiled_train_step(loss_fn, optimizer, *, name="hvd.step",
                        exchange_buckets=None):
    """Build a :class:`CompiledTrainStep`: forward, backward, the
    gradient exchange and the optimizer's update as one CUDA graph a
    signature on a card, cached in the session's program cache.
    ``exchange_buckets`` (default: the DistributedOptimizer's plan, or
    HOROVOD_EXCHANGE_BUCKETS for a plain optimizer) splits the exchange
    into byte-balanced, layer-ordered buckets."""
    return CompiledTrainStep(loss_fn, optimizer, name=name,
                             exchange_buckets=exchange_buckets)
