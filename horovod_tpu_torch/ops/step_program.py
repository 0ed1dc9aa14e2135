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

The step's regions run under the phase trace's ranges (``hvd_forward``,
``hvd_backward``, ``hvd_exchange``, ``hvd_optimizer``;
diag/xla_trace.py), which a replay cannot show: while a trace runs, a
program replays under ``hvd_graph:<key>``, and the first time a window
replays it without a phase map it captures its function once more
under ``hvd_recapture:<key>`` (nothing executes; the graph is dropped,
and the launch counts, the ``_jit`` records and the tensors the step
rebinds are put back as they were), the join's map of each node to its
phase. A step counts its FLOPs once, on its signature's warm-up call
(``torch.utils.flop_counter.FlopCounterMode``, plus the hand kernels'
own counts: ops/flash_attention.py ``count_flops``), for MFU.

On the CPU nothing is captured (gloo is not capturable and the CPU has no
graphs): a program is its step function run as it is, under the same
signatures, cache counters and fallback reasons, as the JAX package
compiles for the CPU. On a card a capture that fails raises; nothing
runs eagerly in its place.
"""

import contextlib
import hashlib
import itertools
import weakref

import torch
from torch.profiler import record_function

from .. import metrics, runtime
from ..config import Config, step_program_enabled
from ..diag import xla_trace
from ..stats import replay_jit, untraced
from ..utils.logging import get_logger
from . import flash_attention as fa
from .collectives import exchange_bucket_plan, grouped_allreduce

__all__ = ["CompiledTrainStep", "StepProgram", "compiled_train_step",
           "engine_cached_program"]

_token_registry = weakref.WeakKeyDictionary()
_token_counter = itertools.count()
_program_counter = itertools.count()
_logger = get_logger()


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


def _callable_digest(fn):
    """Content digest of a callable: code bytes of the function, nested
    code constants, and closure cells holding callables or simple
    scalars. Two structurally identical loss functions digest equal (so
    a re-created loop re-hits the sentry's baseline); a changed
    hyperparameter in a closure changes the digest."""
    h = hashlib.sha1()
    seen = set()

    def feed(obj):
        code = getattr(obj, "__code__", None)
        if code is None or id(code) in seen:
            h.update(type(obj).__name__.encode())
            return
        seen.add(id(code))
        h.update(code.co_name.encode())
        h.update(code.co_code)
        for const in code.co_consts:
            if hasattr(const, "co_code"):
                h.update(const.co_name.encode())
                h.update(const.co_code)
        for cell in getattr(obj, "__closure__", None) or ():
            try:
                v = cell.cell_contents
            except ValueError:
                continue
            if callable(v):
                feed(v)
            elif isinstance(v, (bool, int, float, str, bytes, type(None))):
                h.update(repr(v).encode())
    feed(fn)
    return h.hexdigest()[:12]


@contextlib.contextmanager
def _flop_counter():
    """Count the FLOPs of the block: ``FlopCounterMode``'s for the torch
    ops plus the hand kernels' own (invisible to it: ctypes launches).
    Yields a one-element list filled with the total at exit."""
    from torch.utils.flop_counter import FlopCounterMode
    total = [0]
    with fa.count_flops() as kernels, \
            FlopCounterMode(display=False) as counter:
        yield total
    total[0] = counter.get_total_flops() + kernels[0]


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
    caller that keeps it copies it first.

    ``count_flops`` counts the FLOPs of the first call (the warm-up on a
    card) into :attr:`flops`. ``state()`` returns the tensors whose
    ``.data`` and ``.grad`` the function rebinds (a step's parameters),
    which the phase map's re-capture puts back (module docstring)."""

    def __init__(self, fn, device, pool=None, inputs=(), count_flops=False,
                 state=None):
        self._fn = fn
        self.inputs = list(inputs)  # the static tensors a caller fills
        self._device = torch.device(device)
        self._pool = pool
        self._graph = None
        self._out = None
        self.launches = {}     # kernel launches of one replay, by counter
        self.collectives = []  # (op, nbytes) a replay records
        self.flops = None if count_flops else 0
        self._state = state
        # the phase trace's name for this program's map (no "/")
        self.phase_key = f"p{next(_program_counter)}"
        cfg = Config.from_env()
        self._capture = (self._device.type == "cuda"
                         and step_program_enabled(cfg))
        self._callbacks = cfg.profiler_jit_callbacks

    @property
    def captured(self):
        return self._graph is not None

    def _first_run(self):
        """``fn()``, its FLOPs counted when they are wanted and unknown."""
        if self.flops is not None:
            return self._fn()
        with _flop_counter() as total:
            out = self._fn()
        self.flops = total[0]
        return out

    def __call__(self):
        if not self._capture:
            return self._first_run()
        if self._graph is None:
            return self._warm_up_and_capture()
        tracer = xla_trace.get()
        if tracer is not None and tracer.active:
            if tracer.wants_phase_map(self.phase_key):
                self._map_phases(tracer)
            with record_function(xla_trace.GRAPH_PREFIX + self.phase_key):
                self._graph.replay()
        else:
            self._graph.replay()
        fa.count_replay(self.launches)
        if self._callbacks:
            replay_jit(self.collectives)
        return self._out

    def _map_phases(self, tracer):
        """Capture ``fn`` once more under the running trace, inside
        ``hvd_recapture:<key>``, for the phase map (module docstring).
        Nothing executes and the graph is dropped; the launch counts,
        the ``_jit`` records and the rebound tensors stay as they were."""
        saved = [(t, t.data, t.grad) for t in
                 (self._state() if self._state is not None else ())]
        launches0 = fa.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with untraced(), record_function(
                    xla_trace.RECAPTURE_PREFIX + self.phase_key):
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    self._fn()
        except Exception:  # noqa: BLE001 - tracing must never kill a step
            # without a map the window's replays stay unmatched (counted)
            _logger.warning("phase map re-capture of %s failed",
                            self.phase_key, exc_info=True)
        finally:
            fa.uncount_capture(launches0)
            for t, data, grad in saved:
                t.data = data
                t.grad = grad
            del graph
        tracer.register_phase_map(self.phase_key)

    def _warm_up_and_capture(self):
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._first_run()
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
    (``exchange_buckets`` re-plans its buckets); with ``expert_keys``
    (exchange mode ``"moe"``, in the signature as the JAX package keys
    it) those are the data group's all-reduces of the expert gradients
    beside the world's of the rest, and the model's all-to-alls are
    captured with the forward and backward; with ``model_keys`` (mode
    ``"spec"``) each group of leaves all-reduces over its own axes of
    the 3-D mesh, and a tensor-parallel model's psums are captured with
    the forward and backward (NCCL only: a gloo collective moves through
    the host and cannot be captured). The optimizer's sharding spec
    already runs over the smallest runtime mesh that provides its axes,
    the one the JAX package's ``_step_mesh`` picks, and raises in its
    words where none does (optimizers.py ``_spec_mesh``). A plain optimizer gets one
    fused all-reduce a bucket in front of its update (the JAX package's
    auto decomposition). A ZeRO optimizer (modes ``"zero1"``,
    ``"zero2"``, ``"zero3"``, or ``"spec"`` with expert keys) exchanges
    in its ``step()``: the capture takes its chunked reduce-scatters,
    the update of the stripe and the all-gathers (``exchange_buckets``
    re-chunks them); at stage 0 with ``dcn_compression`` the mode is
    ``"none"``: the optimizer's staged exchange is all there is.

    Under ``zero3`` (and a spec at stage 3) the stripe is resident:
    between steps only the optimizer's parameter stripe and its state
    over it persist. Each step starts by gathering the stripe into the
    model's parameters (inside the capture, so the row lives in the
    graph's pool, as XLA keeps it among the program's temporaries) and
    leaves them as they were gathered, one update behind:
    :meth:`unshard_params` reads the trained parameters,
    :meth:`shard_params` loads new ones. The guard raises here.

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
        tag = getattr(optimizer, "_hvd_exchange", None)
        wrapped = tag in ("hooks", "zero1", "zero2", "zero3", "spec",
                          "inline")
        if wrapped and optimizer.backward_passes_per_step > 1:
            raise ValueError(
                "compiled_train_step cannot introspect "
                "DistributedOptimizer(backward_passes_per_step>1); "
                "compile the inner step and accumulate outside")
        if wrapped and exchange_buckets is not None:
            optimizer.plan_exchange(exchange_buckets)
        self.name = name
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._buckets = exchange_buckets
        if tag == "hooks":
            self._exchange = optimizer._hvd_mode
        elif tag == "inline":
            self._exchange = "none"
        else:
            self._exchange = tag if wrapped else "psum"
        self._resident = (wrapped and tag != "hooks"
                          and optimizer.zero_stage == 3)
        self._params = (optimizer._params if wrapped and tag != "hooks"
                        else [p for g in optimizer.param_groups
                              for p in g["params"] if p.requires_grad])
        self._layout = tuple((tuple(p.shape), str(p.dtype), str(p.device))
                             for p in self._params)
        self._programs = None
        self._signatures = set()
        self.cache_hits = 0
        self.cache_misses = 0
        self.compiled_steps = 0
        self.fallback_steps = 0
        # whole-program FLOPs of the last step (every rank's), for MFU
        self.flops_per_step = 0.0

    @property
    def perf_signature(self):
        """Stable short workload id for the perf-sentry baseline (the
        model-digest component; the caller appends batch/world/zero)."""
        return f"{_callable_digest(self._loss_fn)[:12]}|{self._exchange}"

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

    def shard_params(self, params=None):
        """Full parameters -> this rank's stripe, loaded into the
        optimizer as the resident truth (``zero3``): ``params`` are full
        tensors in the optimizer's parameter order, default the model's
        as they are. Returns the stripe (the optimizer's flat
        parameter), ``ceil(total / n)`` long."""
        self._check_resident("shard_params")
        return self._optimizer.shard(params)

    def unshard_params(self, stripe=None):
        """Stripe (default the optimizer's) -> the full parameters, in
        its parameter order, by the full-width gather: exact. For eval,
        checkpoints, or handing back to unsharded code."""
        self._check_resident("unshard_params")
        return self._optimizer.unshard(stripe)

    def _check_resident(self, what):
        if not self._resident:
            raise ValueError(
                f"{what} needs the stripe-resident layout: a "
                "DistributedOptimizer(zero_stage=3) transform (exchange "
                f"mode {self._exchange!r})")

    def _bucket_count(self, cfg):
        if self._exchange != "psum":
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
        if self._resident:
            self._optimizer.materialize()
        with record_function("hvd_forward"):
            loss = self._loss_fn(*batch)
        with record_function("hvd_backward"):
            loss.backward()
        if self._exchange == "psum":
            with record_function("hvd_exchange"):
                self._psum(buckets)
        with record_function("hvd_optimizer"):
            self._optimizer.step()
        return loss.detach()

    def _signature(self, device, batch, buckets):
        return ("step_program", self._exchange, buckets,
                obj_token(self._optimizer), obj_token(self._loss_fn),
                self._layout, _hyperparameters(self._optimizer),
                tuple((tuple(x.shape), str(x.dtype), str(x.device))
                      for x in batch), str(device))

    def _build(self, st, sig, batch, buckets):
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
        # The program holds its step weakly, and the step's finalizer
        # drops the program from the cache: a session's cache outlives
        # the steps built in it, and must not keep a dropped step's model
        # and optimizer on the card (the JAX package's cached programs
        # hold no device buffers either).
        ref = weakref.ref(self)
        weakref.finalize(self, st.programs.discard, sig)
        return StepProgram(lambda: ref()._step(inputs, buckets), device,
                           pool, inputs, count_flops=True,
                           state=lambda: ref()._rebound())

    def _rebound(self):
        """The tensors a step rebinds (``.grad``, and ``.data`` under
        zero3): the parameters and a ZeRO optimizer's stripe."""
        stripe = getattr(self._optimizer, "stripe", None)
        return self._params + ([stripe] if stripe is not None else [])

    def __call__(self, *batch):
        st = runtime.live_state()
        if st.programs is not self._programs:
            # a new session: its cache is cold, and so are the
            # signatures this object saw in the old one
            self._programs = st.programs
            self._signatures = set()
        cfg = st.config
        buckets = self._bucket_count(cfg)
        if self._resident and not self._optimizer._resident:
            self._optimizer.shard()
        if not step_program_enabled(cfg):
            reason = "disabled" if cfg.step_program == 0 else "host_mode"
            return self._fallback(reason, batch, buckets)
        sig = self._signature(st.device, batch, buckets)
        if sig not in self._signatures:
            if len(self._signatures) >= cfg.step_program_churn_limit:
                return self._fallback("shape_churn", batch, buckets)
            self._signatures.add(sig)
        prog, was_hit = st.programs.get(
            sig, lambda: self._build(st, sig, batch, buckets))
        if was_hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        metrics.STEP_PROGRAM_CACHE_HITS.set(st.programs.hits)
        metrics.STEP_PROGRAM_CACHE_MISSES.set(st.programs.misses)
        for dst, src in zip(prog.inputs, batch):
            dst.copy_(src)
        captured = prog.captured
        tracer = xla_trace.get()
        if tracer is not None:
            tracer.tick(owner=self)
        loss = prog()
        metrics.STEP_COMPILED_TOTAL.inc()
        self.compiled_steps += 1
        if prog.flops:
            self.flops_per_step = float(prog.flops) * st.size
            metrics.STEP_FLOPS_TOTAL.inc(self.flops_per_step)
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
