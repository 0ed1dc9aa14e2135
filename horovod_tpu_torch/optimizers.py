"""Data-parallel training: the distributed optimizer and state broadcast.

Counterpart of the torch binding of the JAX package
(horovod_tpu/torch/__init__.py: ``DistributedOptimizer``,
``broadcast_parameters``, ``broadcast_optimizer_state``) and of the
knobs of horovod_tpu/optimizers.py::DistributedOptimizer that apply at
``zero_stage=0``.

Gradients are averaged over the ranks by post-accumulate-grad hooks.
The parameters are grouped by :func:`exchange_bucket_plan` into
``exchange_buckets`` byte-balanced, reverse-order buckets (default
``HOROVOD_EXCHANGE_BUCKETS``, 1: one fused exchange, as the JAX
package's ``psum`` tag does). The hook that completes a bucket flattens
its gradients into one buffer per dtype and launches their all-reduce
asynchronously, so later buckets' backward overlaps it;
:meth:`synchronize` waits for every bucket and copies the averages back.

The exchange runs at every world size, one included: the JAX package's
binding registers no hooks at ``size() == 1``, but then a one-card run
would never execute the path this module is for. At one rank NCCL's
in-place all-reduce does no device work, so there the exchange costs
its copies into and out of the flat buffer; the stats time it from
before the first to after the last.

ZeRO stages 1-3 and the DCN-staged exchange (ROADMAP.md, Queue 1 item
11), expert and model keys (items 7 and 6) and Int8 compression (item 3)
raise ``NotImplementedError``.
"""

import warnings
import weakref

import torch

from . import config as config_mod
from . import metrics, runtime
from .ops.collectives import (Exchange, broadcast_, exchange_bucket_plan,
                              flatten_by_dtype, start_allreduce, unflatten)
from .ops.compression import Compression, Int8Compressor


class _DistributedOptimizer(torch.optim.Optimizer):
    """Allreduce-averaging optimizer wrapper, mixed into the wrapped
    optimizer's class (see :func:`DistributedOptimizer`)."""

    # What ops/step_program.py reads: the gradient hooks exchange, so a
    # compiled step adds no exchange of its own.
    _hvd_exchange = "hooks"

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step, exchange_buckets):
        super(self.__class__, self).__init__(params)
        self._compression = compression

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [(f"allreduce.noname.{i}", v)
                                for param_group in self.param_groups
                                for i, v in enumerate(param_group["params"])]

        if any(not isinstance(p, tuple) for p in named_parameters):
            raise ValueError("named_parameters should be a sequence of "
                             "tuples (name, parameter), usually produced by "
                             "model.named_parameters().")
        names = [k for k, _ in named_parameters]
        dups = {n for n in names if names.count(n) > 1}
        if dups:
            raise ValueError("Parameter names in named_parameters must be "
                             "unique. Found duplicates: %s"
                             % ", ".join(sorted(dups)))

        self.backward_passes_per_step = backward_passes_per_step
        self._size = runtime.size()
        params = [p for group in self.param_groups for p in group["params"]
                  if p.requires_grad]
        self._allreduce_delay = {p: backward_passes_per_step for p in params}
        self.plan_exchange(exchange_buckets)
        self._inflight = {}  # bucket -> (exchange, [(indices, flat)], ctxs)
        self._synchronized = False
        # The hooks hold the optimizer weakly. A bound method would tie
        # each parameter to the optimizer in a cycle that the garbage
        # collector does not free (it runs through the parameter's hook
        # table), so a deleted model and optimizer, with their gradients
        # and state, would stay on the card for the process's life.
        ref = weakref.ref(self)

        def hook(p):
            opt = ref()
            if opt is not None:
                opt._hook(p)

        self._hook_handles = [p.register_post_accumulate_grad_hook(hook)
                              for p in params]

    @property
    def exchange_buckets(self):
        """The parameters of each bucket, in launch order."""
        return [list(b) for b in self._buckets]

    def plan_exchange(self, exchange_buckets):
        """Group the parameters into at most ``exchange_buckets``
        buckets (:func:`exchange_bucket_plan`); call between steps."""
        params = list(self._allreduce_delay)
        self._buckets = [[params[i] for i in idx]
                         for idx in exchange_bucket_plan(params,
                                                         exchange_buckets)]
        self._bucket_of = {p: b for b, ps in enumerate(self._buckets)
                           for p in ps}
        self._ready = [0] * len(self._buckets)

    def _hook(self, p):
        if self._allreduce_delay[p] <= 0:
            raise AssertionError(
                "Gradients were computed more than "
                "backward_passes_per_step times before call "
                "to step(). Increase backward_passes_per_step to "
                "accumulate gradients locally.")
        self._allreduce_delay[p] -= 1
        if self._allreduce_delay[p] == 0:
            b = self._bucket_of[p]
            self._ready[b] += 1
            if self._ready[b] == len(self._buckets[b]):
                self._launch(b)

    def _launch(self, b):
        """Flatten bucket ``b``'s gradients (one buffer per dtype, after
        compression) and start their all-reduce. The exchange's clock
        runs from before the copy in to after the copy out
        (:meth:`synchronize`)."""
        exchange = Exchange("allreduce")
        compressed = [self._compression.compress(p.grad)
                      for p in self._buckets[b]]
        groups = [(idx, flat) for _, idx, flat in
                  flatten_by_dtype([w for w, _ in compressed])]
        for _, flat in groups:
            start_allreduce(flat, exchange)
        self._inflight[b] = (exchange, groups, compressed)

    def synchronize(self):
        """Finish every bucket's exchange so gradients can be inspected
        or clipped before ``step(synchronize=False)``. A bucket whose
        hooks did not all fire this pass is launched here; a parameter
        whose grad is still None gets a zero grad first, so every rank
        submits the same buffers."""
        for b, params in enumerate(self._buckets):
            if b in self._inflight:
                continue
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p.data)
            self._launch(b)
        for b, (exchange, groups, compressed) in self._inflight.items():
            params = self._buckets[b]
            exchange.wait()
            for idx, flat in groups:
                flat = self._compression.decompress(
                    flat, compressed[idx[0]][1])
                flat.div_(self._size)
                for i, avg in zip(idx, unflatten(flat,
                                                 [params[i] for i in idx])):
                    params[i].grad.copy_(avg)
            exchange.done()
        for p in self._allreduce_delay:
            self._allreduce_delay[p] = self.backward_passes_per_step
        self._ready = [0] * len(self._buckets)
        self._inflight.clear()
        self._synchronized = True

    def step(self, closure=None, synchronize=True):
        if synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step(synchronize=True) called after "
                    "optimizer.synchronize(). This can cause training "
                    "slowdown. You may want to consider using "
                    "optimizer.step(synchronize=False) if you use "
                    "optimizer.synchronize() in your code.")
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, zero_stage=None,
                         exchange_buckets=None, dcn_compression=None,
                         expert_keys=None, model_keys=None):
    """Wrap a torch optimizer so its gradients are averaged over every
    rank during the backward.

    ``zero_stage`` and ``exchange_buckets`` default to
    ``HOROVOD_ZERO_STAGE`` and ``HOROVOD_EXCHANGE_BUCKETS``; only stage 0
    is carried. Gradients accumulated over ``backward_passes_per_step``
    backward passes are summed locally, then averaged over the ranks, as
    the reference's torch binding does."""
    cfg = config_mod.Config.from_env()
    zero_stage = cfg.zero_stage if zero_stage is None else int(zero_stage)
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage must be 0..3, got {zero_stage}")
    if zero_stage:
        raise NotImplementedError(
            f"zero_stage={zero_stage} is not ported yet (ROADMAP.md, Queue 1 "
            "item 11)")
    if dcn_compression is None:
        dcn_compression = cfg.dcn_compression
    if dcn_compression:
        raise NotImplementedError(
            "dcn_compression is not ported yet (ROADMAP.md, Queue 1 item 11)")
    if expert_keys:
        raise NotImplementedError(
            "expert_keys are not ported yet (ROADMAP.md, Queue 1 item 7)")
    if model_keys:
        raise NotImplementedError(
            "model_keys are not ported yet (ROADMAP.md, Queue 1 item 6)")
    if compression is Int8Compressor:
        raise NotImplementedError(Int8Compressor.MESSAGE)
    if exchange_buckets is None:
        exchange_buckets = cfg.exchange_buckets
    metrics.ZERO_STAGE.set(0)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, exchange_buckets)


def broadcast_parameters(params, root_rank):
    """Broadcast model parameters from ``root_rank`` in place. Accepts a
    state_dict or a list of (name, tensor) pairs."""
    if isinstance(params, dict):
        params = sorted(params.items())
    elif isinstance(params, list):
        params = sorted(params, key=lambda kv: kv[0])
    else:
        raise ValueError("invalid params of type: %s" % type(params))
    with torch.no_grad():
        for _, p in params:
            if torch.is_tensor(p):
                broadcast_(p.data, root_rank)


def broadcast_optimizer_state(optimizer, root_rank):
    """Broadcast optimizer state (hyperparameters such as lr included)
    from ``root_rank``. Scalars travel as float64 tensors and are written
    back with their original Python type."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    state_dict = optimizer.state_dict()

    scalars = {}
    tensors = {}

    def visit(prefix, obj):
        if torch.is_tensor(obj):
            tensors[prefix] = obj
        elif isinstance(obj, (int, float, bool)):
            scalars[prefix] = obj
        elif isinstance(obj, dict):
            for k, v in sorted(obj.items(), key=lambda kv: str(kv[0])):
                visit(f"{prefix}.{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                visit(f"{prefix}.{i}", v)

    visit("state", state_dict["state"])
    for gi, group in enumerate(state_dict["param_groups"]):
        for k, v in sorted(group.items()):
            if k != "params":
                visit(f"group.{gi}.{k}", v)

    with torch.no_grad():
        for _, t in sorted(tensors.items()):
            broadcast_(t, root_rank)

    updated = {}
    for key, v in sorted(scalars.items()):
        wire = torch.tensor([float(v)], dtype=torch.float64)
        broadcast_(wire, root_rank)
        updated[key] = type(v)(wire.item())

    for gi, group in enumerate(optimizer.param_groups):
        for k in list(group.keys()):
            key = f"group.{gi}.{k}"
            if key in updated:
                group[k] = updated[key]
