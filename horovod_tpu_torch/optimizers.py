"""Data-parallel training: the distributed optimizer and state broadcast.

Counterpart of the torch binding of the JAX package
(horovod_tpu/torch/__init__.py: ``DistributedOptimizer``,
``broadcast_parameters``, ``broadcast_optimizer_state``) and of
horovod_tpu/optimizers.py::DistributedOptimizer's layouts: the ZeRO
ladder, the DCN-staged exchange and the per-leaf sharding spec.

At ``zero_stage=0`` gradients are averaged over the ranks by
post-accumulate-grad hooks. The parameters are grouped by
:func:`exchange_bucket_plan` into ``exchange_buckets`` byte-balanced,
reverse-order buckets (default ``HOROVOD_EXCHANGE_BUCKETS``, 1: one
fused exchange, as the JAX package's ``psum`` tag does). The hook that
completes a bucket flattens its gradients into one buffer per dtype and
launches their all-reduce asynchronously, so later buckets' backward
overlaps it; :meth:`synchronize` waits for every bucket and copies the
averages back.

The exchange runs at every world size, one included: the JAX package's
binding registers no hooks at ``size() == 1``, but then a one-card run
would never execute the path this module is for. At one rank NCCL's
in-place all-reduce does no device work, so there the exchange costs
its copies into and out of the flat buffer; the stats time it from
before the first to after the last.

``expert_keys`` (the counterpart of the JAX package's ``_MoECore``)
name the expert-sharded parameters of MoE layers by substring of their
names: their gradients all-reduce over the data sub-group of the
runtime's ``expert_mesh()`` (axis ``hvd``; every rank when no expert
mesh was built), every other gradient over the world, and both divide
by the full world size N. The expert group's all-to-all already
brought its peers' cotangents into each expert shard's gradient, so the
data-group sum completes the global sum. Each flat buffer of a bucket's
exchange holds one dtype and one group. A :class:`_ShardingSpec` holds
that per-leaf layout for every path.

At ``zero_stage`` 1-3, and at stage 0 with ``dcn_compression``, the
exchange runs in :meth:`synchronize` once every gradient has landed
(:class:`_ShardedOptimizer` over a :class:`_ZeroCore`): no hooks. At
one rank its scatter and gather are copies and its division is by 1, so
a ZeRO step gives stage 0's bits with an elementwise optimizer.

``model_keys`` name the tensor-parallel parameters (Megatron's heads,
FFN halves and vocabulary stripes, each rank its own shard; the exact
names come from ``models.transformer.model_parallel_keys``) over the
``model`` axis of the runtime's ``model_mesh()``: their gradients reduce
over every other axis and average by those axes' sizes, the rest reduce
over every axis, one all-reduce a group of leaves in the hooks or the
spec's pre-reduce in front of a ZeRO stripe. A spec whose axes no
runtime mesh provides raises; nothing falls back to a layout without
them. ``compression=Compression.int8`` is refused: its per-rank scale
a plain all-reduce cannot sum (int8 runs as ``dcn_compression``).
"""

import warnings
import weakref
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from . import config as config_mod
from . import metrics, runtime
from .ops.collectives import (Exchange, _all_gather, _nbytes,
                              _reduce_scatter, _rs_bucket_bytes, broadcast_,
                              dcn_sigma, dcn_staged_all_gather,
                              dcn_staged_psum_scatter, exchange_bucket_plan,
                              flatten_by_dtype, mesh_axes,
                              normalize_dcn_local_size, start_allreduce,
                              unflatten, world_axis)
from .ops.compression import (BF16Compressor, Compression, Int8Compressor,
                              NoneCompressor)
from .stats import record_jit_traced


def _named(optimizer, named_parameters):
    """``[(name, parameter)]`` of the wrapped optimizer's parameters,
    checked as the reference's binding checks them (unnamed parameters
    are ``allreduce.noname.<i>``)."""
    if named_parameters is not None:
        named_parameters = list(named_parameters)
    else:
        named_parameters = [(f"allreduce.noname.{i}", v)
                            for param_group in optimizer.param_groups
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
    return named_parameters


class _DistributedOptimizer(torch.optim.Optimizer):
    """Allreduce-averaging optimizer wrapper, mixed into the wrapped
    optimizer's class (see :func:`DistributedOptimizer`)."""

    # What ops/step_program.py reads: the gradient hooks exchange, so a
    # compiled step adds no exchange of its own.
    _hvd_exchange = "hooks"

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step, exchange_buckets, spec, mode):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self._hvd_mode = mode  # the compiled step's exchange mode
        self.backward_passes_per_step = backward_passes_per_step
        params = [p for group in self.param_groups for p in group["params"]
                  if p.requires_grad]
        # Each parameter's exchange group and divisor, from the spec:
        # the data sub-group for expert leaves, the group of every axis
        # but the model axis for model leaves (divided by its size),
        # the world (None) for the rest.
        self.expert_keys = spec.expert_keys
        self._spec = spec
        lspecs = spec.leaf_specs(_names_of(params, named_parameters),
                                 gauge=mode == "spec")
        self._group_of = {p: (spec.group_for(ls.reduce),
                              spec.size_of(ls.denom))
                          for p, ls in zip(params, lspecs)}
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
        """Flatten bucket ``b``'s gradients (one buffer per exchange group
        and dtype, after compression) and start their all-reduce, as the
        exchange ``<optimizer>.grads.bucket<b>`` (the phase trace's
        ``hvd_exchange``). The exchange's clock runs from before the copy
        in to after the copy out (:meth:`synchronize`)."""
        with record_function("hvd_exchange"):
            exchange = Exchange("allreduce",
                                f"{type(self).__name__}.grads.bucket{b}")
            params = self._buckets[b]
            compressed = [self._compression.compress(p.grad)
                          for p in params]
            by_group = {}
            for i, p in enumerate(params):
                by_group.setdefault(self._group_of[p], []).append(i)
            groups = []
            for (pg, denom), members in by_group.items():
                for _, idx, flat in flatten_by_dtype(
                        [compressed[i][0] for i in members]):
                    groups.append(([members[i] for i in idx], flat, denom))
                    if pg is None or dist.get_world_size(pg) > 1:
                        start_allreduce(flat, exchange, pg)
            self._inflight[b] = (exchange, groups, compressed)

    def synchronize(self):
        """Finish every bucket's exchange so gradients can be inspected
        or clipped before ``step(synchronize=False)``. A bucket whose
        hooks did not all fire this pass is launched here; a parameter
        whose grad is still None gets a zero grad first, so every rank
        submits the same buffers."""
        with record_function("hvd_exchange"):
            self._synchronize()

    def _synchronize(self):
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
            for idx, flat, denom in groups:
                flat = self._compression.decompress(
                    flat, compressed[idx[0]][1])
                flat.div_(denom)
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


def _names_of(params, named_parameters):
    """Each parameter's name ("" for one ``named_parameters`` leaves out)."""
    by_id = {id(p): n for n, p in named_parameters}
    return [by_id.get(id(p), "") for p in params]


class _LeafSpec(NamedTuple):
    """Per-leaf exchange recipe: ``reduce`` names the mesh axes this
    leaf's gradient is summed over; ``denom`` names the axes whose size
    product divides it when averaging. The two differ for expert leaves,
    whose backward all-to-all already summed the expert-axis peers into
    the local gradient: they sum over the data axis only but still
    divide by the full world."""
    reduce: tuple
    denom: tuple


def _spec_mesh(spec):
    """``(axes, mesh)`` a spec runs over: the 1-D world (mesh None)
    without sharded axes, else the smallest runtime mesh providing every
    axis the spec names (the JAX package's ``CompiledTrainStep.
    _step_mesh``, in its words when none does): the 2-D (data, expert)
    ``expert_mesh()`` or the 3-D (data, expert, model) ``model_mesh()``.
    An expert axis alone with no expert mesh (one rank, or
    ``HOROVOD_EXPERT_PARALLEL`` unset) folds into the dense set: every
    expert is on each rank."""
    world = spec.data_axes[:1]
    if spec.expert_axis is None and spec.model_axis is None:
        return world, None
    st = runtime.live_state()
    req = set(spec.known_axes)
    for mesh in (st.expert_mesh, st.model_mesh):
        if mesh is not None and req.issubset(mesh.mesh_dim_names):
            return tuple(mesh.mesh_dim_names), mesh
    if spec.model_axis is None:
        return world, None
    raise ValueError(
        f"no runtime mesh provides the sharding-spec axes "
        f"{tuple(sorted(req))}: set HOROVOD_EXPERT_PARALLEL and/or "
        "HOROVOD_MODEL_PARALLEL (Config.expert_parallel / "
        "Config.model_parallel) to degrees > 1 whose product "
        "divides the world size before hvd.init() so the matching "
        "expert/model mesh exists")


class _ShardingSpec:
    """Per-leaf sharding spec: one description of how every parameter
    exchanges its gradient, over the runtime's mesh: the 1-D data axis
    ``hvd``, the 2-D ``(hvd, ep)`` expert mesh (``expert_mesh()``) or
    the 3-D ``(hvd, ep, model)`` model mesh (``model_mesh()``), the
    smallest that provides the spec's axes (:func:`_spec_mesh`).
    Counterpart of the JAX package's ``_ShardingSpec``.

    For each leaf, by name (:meth:`leaf_specs`): expert leaves (an
    ``expert_keys`` substring of the name) reduce over every axis but
    ``expert_axis`` and average by the world; model leaves (a
    ``model_keys`` substring) reduce over every axis but ``model_axis``
    and average by the product of the axes they reduce over (their
    shards are distinct parameters); dense leaves reduce over every axis
    and average by the world. The stage-0 exchange sums each leaf over
    its group (:meth:`group_for`) in the gradient hooks; the ZeRO stripe
    runs over the data axis for every leaf, each leaf first reduced over
    its other axes and divided by the rest of its denominator
    (:func:`_spec_pre_reduce`). On the 1-D mesh both pre-steps vanish,
    and the ladder's own sequence is what runs."""

    def __init__(self, data_axes=runtime.AXIS, expert_axis=None,
                 expert_keys=(), model_axis=None, model_keys=(),
                 average=True, zero_stage=0, dcn_link=False):
        self.data_axes = ((data_axes,) if isinstance(data_axes, str)
                          else tuple(data_axes))
        self.expert_keys = tuple(str(k) for k in (expert_keys or ()))
        self.model_keys = tuple(str(k) for k in (model_keys or ()))
        self.expert_axis = str(expert_axis) if self.expert_keys else None
        self.model_axis = str(model_axis) if self.model_keys else None
        self.average = bool(average)
        self.zero_stage = int(zero_stage)
        # True when the stage-0 exchange carries a DCN error-feedback
        # residual: the exchange then runs staged, not in the hooks.
        self.dcn_link = bool(dcn_link)
        if self.expert_keys and expert_axis is None:
            raise ValueError("expert_keys need an expert_axis")
        if self.model_keys and model_axis is None:
            raise ValueError("model_keys need a model_axis")
        shard_axes = [a for a in (self.expert_axis, self.model_axis)
                      if a is not None]
        if len(set(shard_axes)) != len(shard_axes):
            raise ValueError(
                f"expert_axis and model_axis must differ, both are "
                f"{self.expert_axis!r}")
        for a in shard_axes:
            if a in self.data_axes:
                raise ValueError(
                    f"sharded axis {a!r} collides with the data axes "
                    f"{self.data_axes!r}")
        self.known_axes = self.data_axes + tuple(shard_axes)
        self.mesh_axes, self._mesh = _spec_mesh(self)

    def kind(self, name):
        """``"expert"``, ``"model"`` or ``"dense"``: the family of the
        parameter called ``name``, by substring of its keys."""
        e = any(k in name for k in self.expert_keys)
        m = any(k in name for k in self.model_keys)
        if e and m:
            raise ValueError(
                f"parameter leaf {name} matches both expert_keys and "
                "model_keys — a leaf shards over one axis; tighten the "
                "key patterns (model_parallel_keys gives exact paths)")
        return "expert" if e else ("model" if m else "dense")

    def leaf_specs(self, names, gauge=True):
        """Per-leaf :class:`_LeafSpec`, in order, classified against
        :attr:`mesh_axes` (an expert axis the mesh does not have folds
        into the dense reduce set); sets ``hvd_spec_leaves`` unless
        ``gauge`` is off."""
        axes = self.mesh_axes
        out, counts = [], {"dense": 0, "expert": 0, "model": 0}
        for name in names:
            kind = self.kind(name)
            counts[kind] += 1
            if kind == "expert":
                out.append(_LeafSpec(
                    tuple(a for a in axes if a != self.expert_axis), axes))
            elif kind == "model":
                red = tuple(a for a in axes if a != self.model_axis)
                out.append(_LeafSpec(red, red))
            else:
                out.append(_LeafSpec(axes, axes))
        for kind, n in counts.items():
            if gauge:
                metrics.SPEC_LEAVES.labels(kind=kind).set(n)
        return out

    def group_for(self, axes):
        """The process group that sums over ``axes``: the world (None)
        for every axis of the mesh, else the mesh's group over those
        axes."""
        if set(axes) == set(self.mesh_axes):
            return None
        return mesh_axes(self._mesh, axes).group

    def size_of(self, axes):
        """The product of the sizes of ``axes``."""
        n = 1
        for a in axes:
            n *= (runtime.size() if self._mesh is None
                  else self._mesh.size(self.mesh_axes.index(a)))
        return n

    def stripe_axis(self):
        """The data axis the ZeRO stripe runs over."""
        if self._mesh is None:
            return world_axis()
        return mesh_axes(self._mesh, self.mesh_axes[:1])


def _spec_pre_reduce(leaves, lspecs, spec, stripe):
    """Reduce gradient leaves (flat, in the accumulation dtype) down to
    what the flat stripe exchange over the data axis ``stripe`` expects:
    sum each over its reduce axes except the stripe axis (one fused
    all-reduce a group of leaves), and divide by the part of its
    denominator the stripe scatter will not (``denom / |stripe|``). On
    the 1-D mesh both are no-ops."""
    out = list(leaves)
    by_extra = {}
    for i, ls in enumerate(lspecs):
        extra = tuple(a for a in ls.reduce if a != stripe)
        if extra:
            by_extra.setdefault(extra, []).append(i)
    for extra, idx in by_extra.items():
        flat = torch.cat([leaves[i] for i in idx])
        start_allreduce(flat, group=spec.group_for(extra)).finish()
        for i, part in zip(idx, unflatten(flat, [leaves[i] for i in idx])):
            out[i] = part
    if spec.average:
        for i, ls in enumerate(lspecs):
            factor = spec.size_of(ls.denom) / spec.size_of((stripe,))
            if factor != 1:
                out[i] = out[i] / factor
    return out


class Zero1State(NamedTuple):
    """The ZeRO-1 optimizer state: the base optimizer's state over this
    rank's flat 1/N stripe (no rank holds the full state)."""
    base: Any


class ZeroShardState(NamedTuple):
    """The state of a ZeRO-sharded optimizer (``zero_stage`` 1-3, with
    DCN staging): the base optimizer's state over this rank's stripe and
    the error-feedback residual of the lossy DCN hop (None when the hop
    is lossless or staging is off). Both travel in the optimizer's
    ``state_dict()`` (the residual under ``"dcn_residual"``), so a
    checkpoint restores the compression error's carry with the
    momenta."""
    base: Any
    residual: Any = None


class DcnExchangeState(NamedTuple):
    """The state of the stage-0 staged exchange: its error-feedback
    residual (None when the DCN hop is lossless)."""
    residual: Any = None


class _ZeroCore:
    """Static layout and exchange engine of the ZeRO-sharded optimizer
    and of the compiled zero3 step (ops/step_program.py): the flat
    concat-cast-pad layout, the chunking (``bucket_bytes``, each chunk a
    multiple of n so stripes stay uniform), the stripe-owner index
    (``dcn_sigma``: staging permutes ownership) and the staged-or-plain
    scatter and gather. Runs over ``axis`` (an ops/collectives.py
    ``Axis``; None: the world)."""

    def __init__(self, average, compression, dcn_compression,
                 dcn_local_size, bucket_bytes, chunked,
                 exchange_buckets=None, axis=None):
        self.axis = axis
        self.average = bool(average)
        self.comp = (None if compression is Compression.none
                     else compression)
        self.dcn = dcn_compression or ""
        self.dcn_local = int(dcn_local_size or 0)
        self.bucket_bytes = bucket_bytes
        self.chunked = bool(chunked)
        # None defers to HOROVOD_EXCHANGE_BUCKETS; > 1 overrides the
        # byte-sized chunk count.
        self.exchange_buckets = exchange_buckets
        self._buckets_pin = None  # resolved once, at the first layout
        if self.dcn and self.comp is not None:
            raise ValueError(
                "dcn_compression composes the stage split itself — "
                "combine it with compression=Compression.none")

    # ------------------------------------------------------------ layout

    def axis_size(self):
        return (world_axis() if self.axis is None else self.axis).size

    def _group(self):
        return None if self.axis is None else self.axis.group

    def local_for(self, n):
        return normalize_dcn_local_size(n, self.dcn_local)

    def staged(self, n):
        return self.local_for(n) < n

    def padded_len(self, total, n):
        return -(-total // n) * n

    def _resolved_buckets(self):
        # Pinned at the first layout: the scatter, the gather, the
        # parameter stripe and shard/unshard agree on one chunking for
        # the core's life.
        if self._buckets_pin is None:
            if self.exchange_buckets is not None:
                self._buckets_pin = max(int(self.exchange_buckets), 1)
            else:
                self._buckets_pin = config_mod.Config.from_env() \
                    .exchange_buckets
        return self._buckets_pin

    def chunk_layout(self, padded, itemsize, n):
        """Static ``(start, length)`` chunks, each a multiple of n. An
        exchange-bucket count > 1 sets the number of chunks, else
        ``bucket_bytes`` (default HOROVOD_REDUCE_SCATTER_BUCKET) their
        size. The stripe is chunk-major: every chunk contributes its 1/n
        segment, so chunking changes the stripe's order, never a sum."""
        if not self.chunked or padded == 0:
            return ((0, padded),)
        buckets = self._resolved_buckets()
        if buckets > 1:
            target = -(-padded // buckets)
            per = max(n, -(-target // n) * n)
        else:
            per = max(n, (_rs_bucket_bytes(self.bucket_bytes)
                          // int(itemsize)) // n * n)
        return tuple((s, min(per, padded - s))
                     for s in range(0, padded, per))

    def residual_len(self, total, n, itemsize):
        """Length of the error-feedback carry: the DCN stage's input is
        the ICI chunk (1/local of each chunk), so the carry over all
        chunks is padded/local. 0 when the DCN hop is lossless or
        absent."""
        local = self.local_for(n)
        if not self.dcn or local >= n:
            return 0
        return self.padded_len(total, n) // local

    # ---------------------------------------------------------- exchange

    def scatter(self, leaves, residual, n, free=None):
        """The chunked (reduce-)scatter of the padded flat row of
        ``leaves`` (flat tensors in the accumulation dtype): returns
        ``(stripe, new_residual)``, the stripe chunk-major (each chunk's
        1/n segment at this rank's ``dcn_sigma`` position) and averaged
        after the sum. Each chunk's row is cut from the leaves as it is
        sent (:func:`_row`: the JAX package's ``flatten_pad``, a chunk at
        a time), so the full row never exists; ``free(i)`` is called
        once leaf i is sent, for the caller to drop it."""
        local = self.local_for(n)
        dt = leaves[0].dtype
        total = sum(leaf.numel() for leaf in leaves)
        padded = self.padded_len(total, n)
        stripe = leaves[0].new_empty(padded // n)
        offs, o = [], 0
        for leaf in leaves:
            offs.append(o)
            o += leaf.numel()
        residuals, rpos, spos, done = [], 0, 0, 0
        for start, length in self.chunk_layout(padded, dt.itemsize, n):
            chunk = _row(leaves, offs, start, start + length, total)
            seg = stripe[spos:spos + length // n]
            spos += length // n
            if local < n:
                res_c = None
                if residual is not None:
                    rlen = length // local
                    res_c = residual[rpos:rpos + rlen]
                    rpos += rlen
                got, new_res = dcn_staged_psum_scatter(
                    chunk, self.axis, local=local,
                    dcn_compression=self.dcn, residual=res_c)
                seg.copy_(got)
                if new_res is not None:
                    residuals.append(new_res)
            elif self.comp is not None:
                wire, ctx = self.comp.compress(chunk)
                record_jit_traced("reducescatter_jit", _nbytes(wire))
                seg.copy_(self.comp.decompress(
                    _reduce_scatter(wire.new_empty(length // n), wire,
                                    self._group()), ctx))
            else:
                record_jit_traced("reducescatter_jit", _nbytes(chunk))
                _reduce_scatter(seg, chunk, self._group())
            del chunk
            while free is not None and done < len(leaves) and \
                    offs[done] + leaves[done].numel() <= start + length:
                free(done)
                done += 1
        if self.average and n > 1:
            # dividing by 1 changes no bit: one card skips the pass
            stripe.div_(n)
        new_residual = (torch.cat(residuals) if len(residuals) > 1
                        else residuals[0]) if residuals else None
        return stripe, new_residual

    def gather(self, stripe, padded, n, lossless=False):
        """The padded flat row reassembled from every rank's stripe, the
        inverse of :meth:`scatter`'s layout. ``lossless=True`` keeps the
        DCN hop at full width whatever the compression: the zero3
        parameter gather uses it, so the forward never sees the wire's
        rounding."""
        local = self.local_for(n)
        flat = stripe.new_empty(padded)
        dcn = "" if lossless else self.dcn
        spos = 0
        for start, length in self.chunk_layout(padded, stripe.dtype.itemsize,
                                               n):
            part = stripe[spos:spos + length // n]
            spos += length // n
            if local < n:
                dcn_staged_all_gather(part, self.axis, local=local,
                                      dcn_compression=dcn,
                                      out=flat[start:start + length])
            else:
                record_jit_traced("allgather_jit", _nbytes(part))
                _all_gather(flat[start:start + length], part, self._group())
        return flat

    def sigma(self, n):
        return dcn_sigma(self.axis, self.local_for(n))

    def param_stripe(self, leaves, n, out=None):
        """This rank's stripe of the padded flat row of ``leaves``,
        chunk-major, at the ``dcn_sigma`` owner position: slicing, no
        collective. Copies from the leaves into ``out`` (cast to its
        dtype) where given."""
        sig = self.sigma(n)
        total = sum(leaf.numel() for leaf in leaves)
        padded = self.padded_len(total, n)
        flat = [leaf.reshape(-1) for leaf in leaves]
        offs, o = [], 0
        for leaf in flat:
            offs.append(o)
            o += leaf.numel()
        if out is None:
            out = leaves[0].new_empty(padded // n, dtype=_acc_dtype(leaves))
        spos = 0
        for start, length in self.chunk_layout(padded, out.dtype.itemsize,
                                               n):
            seg = length // n
            a = start + sig * seg
            out[spos:spos + seg].copy_(_row(flat, offs, a, a + seg, total,
                                            out.dtype))
            spos += seg
        return out


def _row(leaves, offs, a, b, total, dtype=None):
    """Elements [a, b) of the zero-padded concatenation of the flat
    ``leaves`` (starting at ``offs``), as one tensor (cast to
    ``dtype``)."""
    parts = []
    for leaf, o in zip(leaves, offs):
        lo, hi = max(a, o), min(b, o + leaf.numel())
        if lo < hi:
            parts.append(leaf[lo - o:hi - o])
    dtype = dtype or leaves[0].dtype
    parts = [x.to(dtype) for x in parts]
    if b > total:
        parts.append(leaves[0].new_zeros(b - max(a, total), dtype=dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _acc_dtype(tensors):
    """The accumulation dtype of a set of leaves: JAX's ``result_type``
    over them (f32 for the flagship's f32 parameters)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _same(a, b):
    if torch.is_tensor(a) or torch.is_tensor(b):
        return (torch.is_tensor(a) and torch.is_tensor(b)
                and a.shape == b.shape and bool(torch.equal(a.cpu(),
                                                            b.cpu())))
    return a == b


def _one_group(optimizer):
    """The wrapped optimizer's hyperparameters, which every param group
    must share: the stripe is one flat vector, and the base optimizer
    runs elementwise over it."""
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in optimizer.param_groups]
    for g in groups[1:]:
        if g.keys() != groups[0].keys() or not all(
                _same(g[k], groups[0][k]) for k in g):
            raise ValueError(
                "DistributedOptimizer(zero_stage>=1) runs the wrapped "
                "optimizer elementwise over one flat stripe of every "
                "parameter, so all param groups must carry the same "
                "hyperparameters; got "
                + ", ".join(repr(sorted(x.items())) for x in groups))
    return groups[0]


class _ShardedOptimizer(torch.optim.Optimizer):
    """The ZeRO-sharded and the DCN-staged exchange, mixed into the
    wrapped optimizer's class (see :func:`DistributedOptimizer`).

    At ``zero_stage`` 1-3 the base optimizer's one param group holds one
    flat parameter, :attr:`stripe`: this rank's 1/n of the padded flat
    row of every parameter, in the accumulation dtype. :meth:`synchronize`
    scatters the gradients (one reduce-scatter a chunk of
    ``_ZeroCore.chunk_layout``; one chunk at stage 1) into the stripe's
    ``.grad``, averaged; :meth:`step` copies the parameters' stripe into
    it, runs the base step on it and all-gathers it, at full width, back
    into the parameters. The JAX package gathers the update and adds it
    to the parameters; this gathers the parameters, which an elementwise
    optimizer makes the same values up to its rounding (and at one rank
    the same bits as stage 0). Where the DCN hop is compressed the
    update (the stripe's change) crosses it, in bf16, and is added, as
    in the JAX package: a rounded parameter never does. At stage 0 with
    ``dcn_compression`` the base optimizer keeps the model's parameters,
    and the staged scatter and its gather replace the all-reduce.

    In a compiled zero3 step (ops/step_program.py) the stripe is
    resident: :meth:`materialize` gathers it into the parameters at the
    start of each step, and the step leaves them stale."""

    def __init__(self, groups, params, names, core, spec, zero_stage,
                 backward_passes_per_step):
        super(self.__class__, self).__init__(groups)
        self.backward_passes_per_step = backward_passes_per_step
        self.expert_keys = () if spec is None else spec.expert_keys
        self.zero_stage = zero_stage
        self._params = params
        self._core = core
        self._spec = spec
        self._lspecs = None if spec is None else spec.leaf_specs(names)
        self._acc = _acc_dtype(params)
        self._n = core.axis_size()
        self._total = sum(p.numel() for p in params)
        self._padded = core.padded_len(self._total, self._n)
        self._striped = zero_stage >= 1
        # what broadcast_optimizer_state reads: the stripe's state is
        # this rank's own
        self._hvd_sharded_state = self._striped
        self._resident = False
        self._synchronized = False
        self._hvd_exchange = ("inline" if not self._striped else
                              "spec" if spec is not None
                              else f"zero{zero_stage}")
        self.stripe = groups[0]["params"][0] if self._striped else None
        rlen = core.residual_len(self._total, self._n, self._acc.itemsize)
        self._residual = (params[0].new_zeros(rlen, dtype=self._acc)
                          if rlen else None)
        if self._striped:
            self._stripe_gauges()

    # ------------------------------------------------------------ layout

    @property
    def exchange_buckets(self):
        """The ``(start, length)`` chunks of the flat row, in order."""
        return list(self._core.chunk_layout(self._padded,
                                            self._acc.itemsize, self._n))

    def plan_exchange(self, exchange_buckets):
        """Chunk the exchange into ``exchange_buckets`` pieces (1: by
        ``bucket_bytes``); call between steps."""
        self._core.exchange_buckets = exchange_buckets
        self._core._buckets_pin = None

    def _stripe_gauges(self):
        shard = self._padded // self._n * self._acc.itemsize
        opt = sum(t.numel() * t.element_size()
                  for t in self.state.get(self.stripe, {}).values()
                  if torch.is_tensor(t))
        metrics.ZERO_STRIPE_BYTES.labels(kind="grads").set(shard)
        metrics.ZERO_STRIPE_BYTES.labels(kind="opt").set(opt)
        metrics.ZERO_STRIPE_BYTES.labels(kind="params").set(
            shard if self.zero_stage == 3 else 0)

    def zero_state(self):
        """This rank's state, as the JAX package's optimizer state names
        it: :class:`DcnExchangeState` at stage 0, :class:`Zero1State` at
        stage 1 with no residual (the reference's ``reduce_scatter=True``
        form), else :class:`ZeroShardState`; views of the live state."""
        if not self._striped:
            return DcnExchangeState(residual=self._residual)
        base = self.state[self.stripe]
        if self.zero_stage == 1 and self._residual is None:
            return Zero1State(base=base)
        return ZeroShardState(base=base, residual=self._residual)

    # ---------------------------------------------------------- exchange

    def zero_grad(self, set_to_none=True):
        for p in self._params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.detach_().zero_()
        super(self.__class__, self).zero_grad(set_to_none)

    def synchronize(self):
        """Exchange the gradients: flatten (after the spec's pre-reduce),
        scatter chunk by chunk. At stages 1-3 the averaged stripe becomes
        :attr:`stripe`'s ``.grad`` and each parameter's gradient is
        dropped once sent (the full gradient does not outlive the
        exchange); at stage 0 the stripe is gathered back into the
        gradients. A parameter whose grad is None sends zeros."""
        with record_function("hvd_exchange"):
            self._synchronize()

    def _synchronize(self):
        n, params = self._n, self._params
        leaves = [(p.grad if p.grad is not None else torch.zeros_like(p))
                  .reshape(-1).to(self._acc) for p in params]
        if self._lspecs is not None:
            leaves = _spec_pre_reduce(leaves, self._lspecs, self._spec,
                                      self._spec.mesh_axes[0])

        def free(i):
            leaves[i] = leaves[i].new_empty(0)
            if self._striped:
                params[i].grad = None

        stripe, new_residual = self._core.scatter(
            leaves, self._residual, n, free=free)
        if new_residual is not None:
            # in place: a captured step reads and writes one buffer
            self._residual.copy_(new_residual)
        if self._striped:
            self.stripe.grad = stripe
        else:
            flat = self._core.gather(stripe, self._padded, n)
            for p, part in zip(params, unflatten(flat, params)):
                if p.grad is None:
                    p.grad = part.to(p.dtype)
                else:
                    p.grad.copy_(part)
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
        if not self._striped:
            return super(self.__class__, self).step(closure)
        stripe = self.stripe.detach()
        # A compressed DCN hop carries the update, as the JAX package's
        # gather does: the parameters themselves never cross it rounded.
        lossy = (not self._resident and bool(self._core.dcn)
                 and self._core.staged(self._n))
        with torch.no_grad():
            if not self._resident:
                # the parameters are the truth between eager steps
                self._core.param_stripe([p.detach() for p in self._params],
                                        self._n, out=stripe)
            old = stripe.clone() if lossy else None
            loss = super(self.__class__, self).step(closure)
            if lossy:
                with record_function("hvd_exchange"):
                    flat = self._core.gather(stripe - old, self._padded,
                                             self._n)
                for p, u in zip(self._params, unflatten(flat, self._params)):
                    p.add_(u.to(p.dtype))
            elif not self._resident:
                with record_function("hvd_exchange"):
                    flat = self._core.gather(stripe, self._padded, self._n,
                                             lossless=True)
                for p, part in zip(self._params,
                                   unflatten(flat, self._params)):
                    p.copy_(part)
        self._stripe_gauges()
        return loss

    # ------------------------------------------------- the zero3 layout

    def shard(self, params=None):
        """Load this rank's stripe of ``params`` (full tensors in the
        optimizer's parameter order; default the parameters as they are)
        into :attr:`stripe` and make it the truth (resident): returns
        the stripe."""
        params = self._params if params is None else list(params)
        with torch.no_grad():
            self._core.param_stripe([p.detach() for p in params], self._n,
                                    out=self.stripe.data)
        self._resident = True
        return self.stripe

    def unshard(self, stripe=None):
        """Full tensors shaped as the parameters from ``stripe`` (default
        :attr:`stripe`): the full-width gather, exact."""
        stripe = self.stripe if stripe is None else stripe
        with torch.no_grad():
            flat = self._core.gather(stripe.detach(), self._padded, self._n,
                                     lossless=True)
        return [part.to(p.dtype, copy=True)
                for p, part in zip(self._params, unflatten(flat,
                                                           self._params))]

    def materialize(self):
        """Point the parameters at a gather of the stripe (full width):
        the start of a resident step. Under capture the row lives in the
        graph's pool, among the step's temporaries."""
        with torch.no_grad():
            flat = self._core.gather(self.stripe.detach(), self._padded,
                                     self._n, lossless=True)
        for p, part in zip(self._params, unflatten(flat, self._params)):
            p.data = part if p.dtype == flat.dtype else part.to(p.dtype)

    # ------------------------------------------------------------ state

    def state_dict(self):
        sd = super(self.__class__, self).state_dict()
        sd["dcn_residual"] = self._residual
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        residual = state_dict.pop("dcn_residual", None)
        super(self.__class__, self).load_state_dict(state_dict)
        if residual is not None and self._residual is not None:
            self._residual.copy_(residual)


def _normalize_dcn_compression(value):
    if value is None:
        return ""
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ("", "none", "0", "off"):
            return ""
        if v in ("bf16", "bfloat16", "fp16", "16"):
            return "bf16"
        if v in ("int8", "8bit", "8"):
            return "int8"
        raise ValueError(f"unknown dcn_compression {value!r} "
                         "(expected '', 'bf16' or 'int8')")
    # compressor classes for API symmetry with compression=
    if value is NoneCompressor or value is Compression.none:
        return ""
    if isinstance(value, type) and issubclass(value, Int8Compressor):
        return "int8"
    if isinstance(value, type) and issubclass(value, BF16Compressor):
        return "bf16"
    raise ValueError(f"unknown dcn_compression {value!r} "
                     "(expected '', 'bf16', 'int8' or a matching "
                     "Compression class)")


def _mix(optimizer, cls):
    """A class of the wrapped optimizer's with ``cls``'s methods."""
    return type(optimizer.__class__.__name__, (optimizer.__class__,),
                dict(cls.__dict__))


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, zero_stage=None,
                         exchange_buckets=None, dcn_compression=None,
                         expert_keys=None, expert_axis="ep", model_keys=None,
                         model_axis="model", reduce_scatter=False,
                         dcn_local_size=None, bucket_bytes=None):
    """Wrap a torch optimizer so its gradients are averaged over every
    rank.

    ``zero_stage`` climbs the ZeRO ladder (default HOROVOD_ZERO_STAGE):

    - ``0``: everything replicated; gradient hooks launch one fused
      all-reduce a bucket during the backward (``exchange_buckets``,
      default HOROVOD_EXCHANGE_BUCKETS).
    - ``1``: optimizer-state sharding. The gradients are
      reduce-scattered, the wrapped optimizer steps this rank's flat 1/N
      stripe (its state shards N ways), and the stripe is all-gathered
      into the parameters. ``reduce_scatter=True`` is this stage's old
      spelling.
    - ``2``: gradient sharding: the scatter runs chunk by chunk
      (``bucket_bytes``, default HOROVOD_REDUCE_SCATTER_BUCKET), and each
      parameter's gradient is dropped once its chunks are sent.
    - ``3``: parameter sharding. Used eagerly it behaves as stage 2;
      ``compiled_train_step`` keeps the stripe resident and gathers the
      parameters inside each step (its ``shard_params`` /
      ``unshard_params`` convert).

    At stages 1-3 the wrapped optimizer must be elementwise (SGD, Adam,
    AdamW, ...), and its param groups must share their hyperparameters.
    The flat row follows the order of its parameters: give them in the
    JAX package's leaf order (sorted keys) where the layout must match
    that package's, rank for rank.

    ``dcn_compression`` ("bf16" or "int8"; default
    HOROVOD_DCN_COMPRESSION) turns on the two-stage exchange at any
    stage: within a host (``dcn_local_size`` ranks, default
    HOROVOD_DCN_LOCAL_SIZE or the launcher's local size) at full width,
    across hosts compressed, with an error-feedback residual in the
    optimizer's state. One rank, or one host, has no cross-host stage.

    Gradients accumulated over ``backward_passes_per_step`` backward
    passes are summed locally, then averaged over the ranks, as the
    reference's torch binding does.

    ``expert_keys`` (name substrings, e.g. ``("moe.w1", "moe.w2")``)
    name the expert-sharded parameters of MoE layers over the runtime's
    ``expert_mesh()`` (module docstring): alone, the hooks' exchange;
    with a ZeRO stage or ``dcn_compression``, a per-leaf sharding spec
    (the stripe over the data axis). ``named_parameters`` must then name
    the parameters. Substrings match as the JAX package's tree paths do,
    so ``"moe"`` alone would also take each MoE layer's router, whose
    gradient the world must average.

    ``model_keys`` (full names, ``models.transformer.model_parallel_keys``)
    name the tensor-parallel parameters, sharded over ``model_axis`` of
    the runtime's ``model_mesh()`` (``HOROVOD_MODEL_PARALLEL``): they
    reduce over the other axes and average by their sizes (module
    docstring). They compose with ``expert_keys``, every ZeRO stage and
    ``dcn_compression``, in one per-leaf sharding spec; a name both key
    sets match raises."""
    cfg = config_mod.Config.from_env()
    if zero_stage is None:
        zero_stage = 1 if reduce_scatter else cfg.zero_stage
    zero_stage = int(zero_stage)
    if reduce_scatter and zero_stage == 0:
        zero_stage = 1
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage must be 0..3, got {zero_stage}")
    if dcn_compression is None:
        dcn_compression = cfg.dcn_compression
    dcn_compression = _normalize_dcn_compression(dcn_compression)
    if dcn_local_size is None:
        dcn_local_size = cfg.dcn_local_size
    if dcn_compression and compression is not Compression.none:
        raise ValueError(
            "dcn_compression already defines the wire precision of the "
            "compressed hop — combine it with compression=Compression.none")
    if compression is Int8Compressor:
        raise NotImplementedError(Int8Compressor.MESSAGE)
    hook_buckets = (cfg.exchange_buckets if exchange_buckets is None
                    else exchange_buckets)
    named = _named(optimizer, named_parameters)
    sharded = bool(expert_keys or model_keys)
    if expert_keys and not model_keys and zero_stage == 0 \
            and not dcn_compression:
        # Pure expert parallelism: the hooks' exchange (the JAX
        # package's "moe" fast path), with its checks and words.
        _moe_checks(runtime.AXIS, expert_axis, expert_keys)
        spec = _ShardingSpec(runtime.AXIS, expert_axis, expert_keys)
        mode = "moe"
    elif sharded:
        spec = _ShardingSpec(runtime.AXIS,
                             expert_axis if expert_keys else None,
                             expert_keys,
                             model_axis if model_keys else None, model_keys,
                             zero_stage=zero_stage,
                             dcn_link=bool(dcn_compression)
                             and zero_stage == 0)
        mode = "spec"
    else:
        spec, mode = _ShardingSpec(), "hooks"
    metrics.ZERO_STAGE.set(zero_stage)
    if zero_stage == 0 and not dcn_compression:
        cls = _mix(optimizer, _DistributedOptimizer)
        return cls(optimizer.param_groups, named, compression,
                   backward_passes_per_step, hook_buckets, spec, mode)
    return _zero_sharded(optimizer, named, compression,
                         backward_passes_per_step, zero_stage,
                         dcn_compression, dcn_local_size, bucket_bytes,
                         exchange_buckets, spec if sharded else None)


def _moe_checks(data_axes, expert_axis, expert_keys):
    """The checks of the JAX package's ``_MoECore``, in its words."""
    data_axes = (data_axes,) if isinstance(data_axes, str) \
        else tuple(data_axes)
    if not tuple(expert_keys):
        raise ValueError(
            "expert_keys must name at least one expert-sharded leaf "
            "(tree-path substrings, e.g. ('moe',))")
    if str(expert_axis) in data_axes:
        raise ValueError(
            f"expert axis {str(expert_axis)!r} collides with the data "
            f"axes {data_axes!r}")


def _zero_sharded(optimizer, named, compression, backward_passes_per_step,
                  zero_stage, dcn_compression, dcn_local_size, bucket_bytes,
                  exchange_buckets, spec):
    """The ZeRO-sharded (stages 1-3) or staged (stage 0) optimizer over
    ``optimizer``'s parameters, with ``spec`` (or None: the 1-D ladder):
    the counterpart of the JAX package's ``_zero_sharded`` and, at stage
    0, of its ``_dcn_grad_exchange`` (and of ``_spec_grad_exchange`` with
    a DCN link; without one, a spec's stage-0 exchange is the hooks')."""
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    names = _names_of(params, named)
    axis = None if spec is None else spec.stripe_axis()
    core = _ZeroCore(True, compression, dcn_compression, dcn_local_size,
                     bucket_bytes, chunked=zero_stage != 1,
                     exchange_buckets=exchange_buckets if zero_stage
                     else None, axis=axis)
    if zero_stage == 0:
        groups = optimizer.param_groups
    else:
        hyper = _one_group(optimizer)
        n = core.axis_size()
        with torch.no_grad():
            stripe = core.param_stripe(
                [p.detach() for p in params], n,
                out=params[0].new_empty(
                    core.padded_len(sum(p.numel() for p in params), n) // n,
                    dtype=_acc_dtype(params)))
        groups = [dict(hyper, params=[torch.nn.Parameter(stripe)])]
    cls = _mix(optimizer, _ShardedOptimizer)
    return cls(groups, params, names, core, spec, zero_stage,
               backward_passes_per_step)


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
    back with their original Python type. A ZeRO optimizer's state over
    its stripe (and its DCN residual) is this rank's own and stays: only
    its 0-d tensors (step counts) and scalars travel."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    state_dict = optimizer.state_dict()

    scalars = {}
    tensors = {}

    sharded = getattr(optimizer, "_hvd_sharded_state", False)

    def visit(prefix, obj):
        if torch.is_tensor(obj):
            if not (sharded and obj.dim() > 0):
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
