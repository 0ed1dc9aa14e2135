"""Collectives over the runtime's process group.

Counterpart of horovod_tpu/ops/collectives.py, carrying what the
training, MoE and ZeRO slices need: :func:`allreduce` (average or sum),
:func:`grouped_allreduce` (one flat buffer per dtype),
:func:`allgather` (dim 0 may differ by rank), :func:`unfuse_segments`
(the fused row's per-tensor results), :func:`broadcast`, the bucket
scheduler :func:`exchange_bucket_plan`, copied from the JAX package, the
expert-parallel exchange :func:`alltoall` / :func:`alltoall_chunked`
(differentiable, over a sub-group), :func:`reducescatter`,
:func:`bucketed_reducescatter_allgather`, :func:`hierarchical_allreduce`
the DCN-staged exchange of the ZeRO ladder
(:func:`dcn_staged_psum_scatter`, :func:`dcn_staged_all_gather`,
:func:`dcn_sigma`), the model axis's collectives of tensor
parallelism (:func:`_psum`, :func:`_pmax`, :func:`_gather_vocab`,
:func:`_axis_index`), and the guard's health rows
(:func:`segment_health`, :func:`tree_health`, and
:func:`reduced_health` for leaves that differ across ranks: a sharded
leaf's, or a ZeRO stripe's). Each function runs on
``torch.distributed`` and records every execution in the session's
stats (stats.py): op, wire bytes, time from launch to completion; the
collectives the JAX package only ever runs inside a jitted program (the
all-to-all, the reduce-scatter family, the staged exchange) record as
``<op>_jit`` with no time, once a call, with the JAX package's byte
counts. Every public function of horovod_tpu/ops/collectives.py has a
counterpart here; its ``rank_index`` is :func:`_axis_index`.

In the JAX package these run inside a mapped program over a mesh axis;
here each rank is a process and calls them eagerly, in the same order on
every rank, as with the reference Horovod. An average is the sum over
ranks divided by ``size()``, taken after decompression. A mesh axis is
an :class:`Axis`: every group of ranks along it and this rank's process
group; ``None`` is the world (the JAX package's ``"hvd"`` axis on the
1-D mesh).
"""

import contextlib
import time
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from .. import runtime
from ..diag import recorder as _recorder
from ..exceptions import HorovodError, HostsUpdatedError, WorkerLostError
from ..stats import record_jit_traced, tracing
from .compression import Compression, Int8Compressor


def _nbytes(x):
    """Wire bytes of a tensor."""
    return x.numel() * x.element_size()


class Exchange:
    """One collective operation, timed from :meth:`__init__` to
    :meth:`done` and recorded then in the session's stats as ``op`` over
    the bytes its launches put on the wire. On a card the time runs
    between CUDA events on the caller's stream (stats.py), so it covers
    the device work queued between the two calls: a fused exchange starts
    its clock before the copy into its flat buffers and stops it after
    the copy out, as the reference's timeline counts its fusion-buffer
    copies in the op.

    ``name`` (default ``op``) names it in the flight recorder
    (diag/recorder.py), which gets the JAX engine's events: ``enqueue``
    here, ``dispatch`` at each launch and ``wire_end`` (``span``: the
    time above; ``wait``: the host's time blocked in :meth:`wait`) when
    it is done, on a card when stats.py resolves its end event. With the
    hang watchdog on, the exchange is watched from its first launch
    until the device has finished it (:meth:`in_flight`).

    Inside a CUDA graph capture (ops/step_program.py) the exchange takes
    no events, which would become graph nodes with no time to read: it
    records as ``<op>_jit`` once, at the capture
    (stats.record_jit_traced), and nothing in the flight recorder."""

    def __init__(self, op, name=None):
        st = runtime.live_state()
        self.op, self.name = op, name or op
        self._stats = st.stats
        self._cuda = st.device.type == "cuda"
        self._captured = (self._cuda
                          and torch.cuda.is_current_stream_capturing())
        self._flight = None if self._captured else _recorder.get()
        if not self._cuda:
            self._t0 = time.perf_counter()
        elif not self._captured:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._works, self._nbytes, self._wait = [], 0, 0.0
        self._end = None
        self.t_dispatch = None
        if self._flight is not None:
            self._flight.record("enqueue", self.name, op)

    def launch(self, fn, nbytes):
        """Start one collective of ``nbytes`` wire bytes: ``fn`` returns
        its async work."""
        with peer_errors():
            self._works.append(fn())
        self._nbytes += nbytes
        if self.t_dispatch is None and not self._captured:
            self.t_dispatch = time.perf_counter()
            wd = _recorder.watchdog()
            if wd is not None:
                wd.track(self)
        if self._flight is not None:
            self._flight.record("dispatch", self.name, self.op, nbytes)
        return self

    def in_flight(self):
        """True while a launched collective, or on a card the exchange's
        end event, has not completed on the device. Polls only."""
        if any(not work.is_completed() for work in self._works):
            return True
        return self._end is not None and not self._end.query()

    def wait(self):
        """Wait for every launched collective (on a card: order the
        caller's stream after them)."""
        t0 = time.perf_counter()
        with peer_errors():
            for work in self._works:
                work.wait()
        self._wait += time.perf_counter() - t0

    def done(self):
        """Stop the clock and record the execution."""
        if self._captured:
            record_jit_traced(f"{self.op}_jit", self._nbytes)
        elif self._cuda:
            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record()
            self._stats.record_events(self.op, self._nbytes, self._start,
                                      self._end, self._on_wire_end)
        else:
            span = time.perf_counter() - self._t0
            self._stats.record(self.op, self._nbytes, span)
            self._on_wire_end(span)

    def _on_wire_end(self, span):
        if self._flight is not None:
            self._flight.record(
                "wire_end", self.name, self.op, self._nbytes,
                extra={"span": span, "wait": self._wait,
                       "hidden": max(span - self._wait, 0.0),
                       "n": len(self._works)})

    def finish(self):
        self.wait()
        self.done()
        return self


# What gloo's transport says when a peer is gone: the connection closed
# or reset under a read, a broken pipe under a write, or the group's own
# timeout (``HOROVOD_ELASTIC_TIMEOUT_SECONDS``) expiring on a send or
# receive. Nothing else: a CUDA fault, an NCCL error or a shape mismatch
# is not a lost peer, and is raised as it is.
_PEER_GONE = ("Connection closed by peer", "Connection reset by peer",
              "Broken pipe", "Timed out waiting")


def peer_error(err):
    """The error a collective's backend error ``err`` stands for: under
    ``HOROVOD_ELASTIC``, when gloo says a peer is gone (``_PEER_GONE``),
    :class:`WorkerLostError`, or :class:`HostsUpdatedError` when the
    peers that left announced a planned departure in the session's
    store; elastic.run recovers from either. Any other error, or any
    error without elastic training, ``err`` itself."""
    if isinstance(err, HorovodError) or not isinstance(err, RuntimeError):
        return err
    st = runtime._state
    if st.config is None or not st.config.elastic:
        return err
    if not any(m in str(err) for m in _PEER_GONE):
        return err
    departed = runtime.departed_ranks()
    if departed:
        exc = HostsUpdatedError(lost_pids=departed)
    else:
        exc = WorkerLostError(message=(
            f"a collective failed with a peer ({err}); the peer is "
            f"treated as lost. Re-rendezvous with the surviving workers "
            f"(horovod_tpu_torch.elastic.run) or restart the job to "
            f"continue."))
    exc.__cause__ = err
    return exc


@contextlib.contextmanager
def peer_errors():
    """Raise :func:`peer_error`'s translation of a backend error."""
    try:
        yield
    except RuntimeError as err:
        translated = peer_error(err)
        if translated is err:
            raise
        raise translated from err


def segment_health(row, segs):
    """The guard's gradient-health digest of a fused, REDUCED row: one
    ``[finite, l2]`` float32 row per segment (``segs`` as
    :func:`unfuse_segments` takes them). ``finite`` is 1.0 iff every
    element of the segment is finite; ``l2`` is the L2 norm over the
    finite elements only. The reduced row is bit-identical on every
    rank, so is the verdict. Plain torch ops: one extra pass over the
    row with temporaries; they capture into a CUDA graph as they are."""
    rows = []
    for off, cnt, *_ in segs:
        seg = row[off:off + cnt].float()
        finite = torch.isfinite(seg)
        all_finite = finite.all().float()
        l2 = torch.sqrt(torch.where(finite, seg * seg, 0.0).sum())
        rows.append(torch.stack([all_finite, l2]))
    if not rows:
        return torch.zeros((0, 2), dtype=torch.float32, device=row.device)
    return torch.stack(rows)


def tree_health(leaves):
    """Per-leaf ``[finite, l2]`` float32 health rows for tensors already
    exchanged (bit-identical across ranks): the :func:`segment_health`
    analog where no fused row exists."""
    rows = []
    device = None
    for leaf in leaves:
        x = leaf.reshape(-1).float()
        device = x.device
        finite = torch.isfinite(x)
        rows.append(torch.stack([finite.all().float(), torch.sqrt(
            torch.where(finite, x * x, 0.0).sum())]))
    if not rows:
        return torch.zeros((0, 2), dtype=torch.float32, device=device)
    return torch.stack(rows)


def health_stats(leaves):
    """``(2, L)`` float32: each leaf's count of non-finite elements and
    the sum of squares of its finite ones, the sums
    :func:`reduced_health` adds up over ranks."""
    bads, sqs = [], []
    for leaf in leaves:
        x = leaf.reshape(-1).float()
        finite = torch.isfinite(x)
        bads.append((~finite).sum().float())
        sqs.append(torch.where(finite, x * x, 0.0).sum())
    return torch.stack([torch.stack(bads), torch.stack(sqs)])


def reduced_health(leaves, axes=()):
    """Per-leaf ``[finite, l2]`` rows of leaves whose values differ
    across the ranks of ``axes`` (a tuple of :class:`Axis`): the
    :func:`health_stats` of each rank, all-reduced over each axis's
    group in turn, then ``[count == 0, sqrt(sum of squares)]``. The rows
    are the same on every rank of the axes, so every rank gates alike.
    The JAX package's rows for expert- or model-sharded leaves
    (``lax.psum`` of the stats over the leaves' missing axes,
    horovod_tpu/ops/step_program.py:459-482, :520-546) and for a
    resident stripe (psummed over every mesh axis, :493-511). With no
    axis of more than one rank these are :func:`tree_health`'s rows."""
    if not leaves:
        return torch.zeros((0, 2), dtype=torch.float32)
    return health_rows(health_stats(leaves), axes)


def health_rows(stats, axes=()):
    """``[count == 0, sqrt(sum of squares)]`` rows of :func:`health_stats`
    columns, each summed over the groups of ``axes`` first."""
    for ax in axes:
        if ax.size > 1:
            dist.all_reduce(stats, group=ax.group)
    return torch.stack([(stats[0] == 0).float(), torch.sqrt(stats[1])],
                       dim=1)


def health_ok(health):
    """0-d bool tensor on the rows' device: every row finite (the gate's
    predicate, evaluated where the rows are, with no host read)."""
    return torch.all((health[:, 0] >= 0.5) & torch.isfinite(health[:, 1]))


def _on_device(tensor):
    """``tensor`` on the runtime's device, contiguous (a copy when it was
    elsewhere: NCCL takes only card tensors)."""
    dev = runtime.live_state().device
    return tensor.to(dev).contiguous()


def start_allreduce(buf, exchange=None, group=None, name=None):
    """Launch an in-place sum of ``buf`` (on the runtime's device,
    contiguous) over the ranks of ``group`` (None: every rank), as part
    of ``exchange`` (default: a new one, named ``name``); returns the
    exchange."""
    if exchange is None:
        exchange = Exchange("allreduce", name)
    return exchange.launch(
        lambda: dist.all_reduce(buf, group=group, async_op=True),
        _nbytes(buf))


def _average(summed, n):
    if summed.is_floating_point() or summed.is_complex():
        return summed.div_(n)
    return summed.div_(n, rounding_mode="trunc")


def allreduce(tensor, average=True, compression=Compression.none, name=None):
    """Sum or average ``tensor`` over every rank; returns a new tensor on
    the runtime's device. ``compression`` narrows the wire (fp16/bf16)
    and restores the dtype after the sum. ``name`` names the exchange in
    the flight recorder."""
    wire, ctx = compression.compress(tensor)
    buf = _on_device(wire).clone()
    start_allreduce(buf, name=name).finish()
    out = compression.decompress(buf, ctx)
    return _average(out, runtime.size()) if average else out


def flatten_by_dtype(tensors):
    """``[(dtype, indices, flat)]``: the tensors concatenated into one
    flat buffer per dtype, in first-seen dtype order."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return [(dtype, idx, torch.cat([tensors[i].reshape(-1) for i in idx]))
            for dtype, idx in groups.items()]


def unflatten(flat, like):
    """Views of ``flat`` shaped as the tensors of ``like``, in order."""
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[off:off + n].view(t.shape))
        off += n
    return out


def grouped_allreduce(tensors, average=True, compression=Compression.none,
                      name=None):
    """Allreduce a list of tensors as one group: one fused all-reduce per
    dtype over the concatenated tensors (the reference's tensor fusion).
    Returns the reduced tensors in order."""
    compressed = [compression.compress(_on_device(t)) for t in tensors]
    wires = [w for w, _ in compressed]
    groups = flatten_by_dtype(wires)
    exchange = Exchange("allreduce", name)
    for _, _, flat in groups:
        start_allreduce(flat, exchange)
    exchange.finish()
    out = [None] * len(tensors)
    n = runtime.size()
    for _, idx, flat in groups:
        for i, part in zip(idx, unflatten(flat, [wires[i] for i in idx])):
            r = compression.decompress(part, compressed[i][1])
            out[i] = _average(r.clone(), n) if average else r.clone()
    return out


def allgather(tensor, name=None, sizes=None):
    """Every rank's ``tensor`` concatenated along dim 0, in rank order.
    Ranks may contribute different dim-0 sizes, the other dims equal
    (the reference's MPI_Allgatherv, collective_operations.cc:68-135):
    ``sizes`` lists them by rank when the caller knows them, else one
    small all-gather learns them first. Each rank's block is padded to
    the largest for the one wire all-gather and sliced back out."""
    buf = _on_device(tensor)
    n = runtime.size()
    if sizes is None:
        dim0 = torch.tensor([buf.shape[0]], dtype=torch.int64,
                            device=buf.device)
        got = [torch.empty_like(dim0) for _ in range(n)]
        dist.all_gather(got, dim0)
        sizes = [int(d) for d in torch.cat(got).tolist()]
    top = max(sizes)
    if buf.shape[0] != top:
        pad = buf.new_zeros((top - buf.shape[0],) + tuple(buf.shape[1:]))
        buf = torch.cat([buf, pad])
    parts = [torch.empty_like(buf) for _ in range(n)]
    Exchange("allgather", name).launch(
        lambda: dist.all_gather(parts, buf, async_op=True),
        _nbytes(buf)).finish()
    return torch.cat([p[:d] for p, d in zip(parts, sizes)], dim=0)


def unfuse_segments(row, segs, world_size, inplace=False):
    """Per-tensor results sliced out of a fused flat row (the engine's
    ``MemcpyOutFusionBuffer``; the JAX package's in-graph
    ``unfuse_segments``). ``segs`` is a tuple of ``(offset, count,
    shape, dtype, average, postscale)`` records: each segment is cast
    from the wire dtype back to its dtype (the decompress), averaged
    over ``world_size`` (a float divide, an integer floor divide) and
    scaled. ``inplace=True`` averages a segment whose dtype is the
    row's in the row itself and returns views of it, with no copy."""
    outs = []
    for off, cnt, shape, dtype, average, postscale in segs:
        out = row[off:off + cnt]
        if out.dtype != dtype:
            out = out.to(dtype)
        elif not inplace:
            out = out.clone()
        if average:
            if out.is_floating_point() or out.is_complex():
                out.div_(world_size)
            else:
                out = torch.div(out, world_size, rounding_mode="floor")
        if postscale is not None:
            out = (out * postscale).to(dtype)
        outs.append(out.view(shape))
    return tuple(outs)


def broadcast_(tensor, root_rank, name=None):
    """Overwrite ``tensor`` in place with ``root_rank``'s value; returns
    it. A tensor off the runtime's device travels through a copy."""
    buf = _on_device(tensor)
    Exchange("broadcast", name).launch(
        lambda: dist.broadcast(buf, src=root_rank, async_op=True),
        _nbytes(buf)).finish()
    if buf.data_ptr() != tensor.data_ptr():
        tensor.copy_(buf)
    return tensor


def broadcast(tensor, root_rank, name=None):
    """``root_rank``'s value of ``tensor`` on every rank, as a new tensor
    on the runtime's device."""
    return broadcast_(_on_device(tensor).clone(), root_rank, name)


def _alltoall_raw(tensor, group, split_axis, concat_axis):
    """The tiled all-to-all of :func:`alltoall`, without autograd: the
    split axis cut into one slice per rank and moved to the front for
    ``all_to_all_single``, the received slices (rank order along dim 0)
    merged into the concat axis."""
    n = dist.get_world_size(group)
    shape = list(tensor.shape)
    if shape[split_axis] % n:
        raise ValueError(
            f"alltoall: split axis {split_axis} of size {shape[split_axis]} "
            f"does not divide over {n} ranks")
    x = tensor.movedim(split_axis, 0)
    x = x.reshape(n, shape[split_axis] // n, *x.shape[1:]).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    # (n, *slice) with the slice in the tensor's own axis order, then the
    # rank axis merged into the concat axis, outermost: rank order.
    out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its backward is the reverse all-to-all
    (split and concat axes swapped), as ``lax.all_to_all``'s transpose."""

    @staticmethod
    def forward(ctx, tensor, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _alltoall_raw(tensor, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return (_alltoall_raw(g.contiguous(), group, concat_axis, split_axis),
                None, None, None)


def alltoall(tensor, group=None, split_axis=0, concat_axis=0):
    """Scatter dim-``split_axis`` slices to each rank of ``group`` (None:
    every rank) and gather the received slices along ``concat_axis``, in
    rank order: ``lax.all_to_all(..., tiled=True)``. Rank j receives
    slice j of every rank. Differentiable: the gradient travels back
    through the reverse all-to-all. Records ``alltoall_jit`` (the bytes
    of ``tensor``) in the session's stats."""
    record_jit_traced("alltoall_jit", _nbytes(tensor))
    return _AllToAll.apply(tensor, group, split_axis, concat_axis)


# ------------------------------------------------ the model axis (TP)
#
# The JAX package's trunk runs these inside ``shard_map(...,
# check_vma=False)``, where the transpose of ``lax.psum`` is a psum and
# that of a tiled ``lax.all_gather`` a psum-scatter. Each is one
# collective over the model group (None: no model axis, the identity),
# not recorded in the session's stats: they are the model's arithmetic,
# as the reference's are part of its program.

def _axis_index(group):
    """This rank's position in ``group`` (0 without one):
    ``lax.axis_index``."""
    return 0 if group is None else dist.get_rank(group)


class _PSum(torch.autograd.Function):
    """The sum over ``group``; its backward sums the cotangents over the
    group too, as ``lax.psum`` transposes under ``check_vma=False`` (not
    Megatron's identity): each rank's gradient before any exchange is
    the reference's per-shard gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _psum(x, group):
    """``lax.psum(x, axis)`` over ``group``; differentiable."""
    return x if group is None else _PSum.apply(x, group)


def _gather_last(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _pmax(x, group):
    """The elementwise max over ``group``, by an all-gather and a max as
    the JAX package takes it, outside autograd (its callers stop the
    gradient)."""
    if group is None:
        return x
    with torch.no_grad():
        return torch.stack(_gather_last(x.detach(), group)).amax(dim=0)


class _GatherVocab(torch.autograd.Function):
    """The tiled all-gather of the last dimension; its backward is the
    psum-scatter (the sum of the cotangents, this rank's block)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return torch.cat(_gather_last(x, group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        i = _axis_index(ctx.group)
        return g[..., i * ctx.width:(i + 1) * ctx.width], None


def _gather_vocab(logits, group):
    """Full-vocab logits from the contiguous vocab stripes of ``group``'s
    ranks, in rank order: ``lax.all_gather(..., axis=-1, tiled=True)``.
    Every rank then holds the same distribution, so every rank selects
    the same token."""
    return logits if group is None else _GatherVocab.apply(logits, group)


def broadcast_object(obj, group):
    """The first rank of ``group``'s ``obj`` (any picklable value) on
    every rank of ``group``: what keeps a model group's ranks in
    lockstep (serve/scheduler.py)."""
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def _largest_divisor_leq(n, k):
    """Largest divisor of ``n`` that is <= ``k`` (static ints)."""
    k = min(max(int(k), 1), int(n))
    while n % k:
        k -= 1
    return k


def alltoall_chunked(tensor, chunks, group=None, split_axis=0,
                     concat_axis=0, chunk_axis=1):
    """:func:`alltoall` split into ``chunks`` independent slices along
    ``chunk_axis``; returns the tuple of per-chunk results. Each chunk
    round-trips on its own, so the results concatenated along
    ``chunk_axis`` equal the unchunked all-to-all bit for bit. A
    ``chunks`` that does not divide the chunk axis falls back to its
    largest divisor below; ``chunks=1`` is one all-to-all. Records one
    ``alltoall_jit`` of the whole tensor's bytes, as the JAX package
    does."""
    k = _largest_divisor_leq(tensor.shape[chunk_axis], chunks)
    record_jit_traced("alltoall_jit", _nbytes(tensor))
    return tuple(_AllToAll.apply(piece, group, split_axis, concat_axis)
                 for piece in torch.chunk(tensor, k, dim=chunk_axis))


def exchange_bucket_plan(leaves, buckets):
    """Partition gradient-leaf indices into at most ``buckets`` contiguous
    groups in reverse leaf order, balanced by payload bytes. Returns a
    tuple of index tuples; every index appears exactly once.

    The JAX package's plan, index for index: the last leaves, whose
    gradients backprop produces first, form the first bucket, so each
    bucket's all-reduce can start while the backward still runs.
    ``buckets=1`` returns the identity plan, all indices ascending. Byte
    balancing is greedy over cumulative equal-bytes boundaries; a cut is
    forced when the leaves remaining would otherwise leave a bucket
    empty.
    """
    n = len(leaves)
    buckets = max(int(buckets), 1)
    if n == 0:
        return ()
    if buckets == 1 or n == 1:
        return (tuple(range(n)),)
    buckets = min(buckets, n)
    order = list(range(n - 1, -1, -1))  # backprop completion order
    sizes = [_nbytes(leaves[i]) for i in order]
    total = sum(sizes) or 1
    boundary = total / buckets
    plan, cur, acc = [], [], 0
    for pos, (i, nb) in enumerate(zip(order, sizes)):
        cur.append(i)
        acc += nb
        remaining_leaves = n - pos - 1
        remaining_buckets = buckets - len(plan) - 1
        if (len(plan) < buckets - 1
                and (acc >= boundary * (len(plan) + 1)
                     or remaining_leaves <= remaining_buckets)):
            plan.append(tuple(cur))
            cur = []
    if cur:
        plan.append(tuple(cur))
    return tuple(plan)


# ------------------------------------------------------ mesh axes, scatter

class Axis(NamedTuple):
    """One mesh axis over the ranks: ``groups`` holds every group of
    ranks along it (global ranks in axis order), ``group`` is this
    rank's process group (None: the world). ``torch.distributed`` builds
    a sub-group collectively, so a collective that needs sub-groups of
    an axis builds them for every group, on every rank."""
    groups: tuple
    group: object

    @property
    def size(self):
        return len(self.groups[0])

    def index(self):
        """This rank's position along the axis."""
        r = runtime.rank()
        return next(g.index(r) for g in self.groups if r in g)


def world_axis():
    """The 1-D data-parallel axis over every rank."""
    return Axis((tuple(range(runtime.size())),), None)


def mesh_axis(mesh, name):
    """The axis ``name`` of a ``DeviceMesh``: its groups are the mesh's
    rows along that dimension."""
    return mesh_axes(mesh, (name,))


def mesh_axes(mesh, names):
    """The axes ``names`` of a ``DeviceMesh`` taken as one: each group
    holds the ranks that share every other coordinate, row-major over
    ``names`` in mesh order (the JAX package's collectives over a tuple
    of axes). One axis is the mesh's own group; several are sub-groups
    built for every group at once, on every rank, and kept for the
    session (``runtime.cached_groups``); all of the mesh's axes are the
    world (None) when the mesh covers it."""
    dims = sorted(mesh.mesh_dim_names.index(n) for n in names)
    rest = [d for d in range(mesh.mesh.ndim) if d not in dims]
    width = 1
    for d in dims:
        width *= mesh.mesh.shape[d]
    rows = mesh.mesh.permute(*rest, *dims).reshape(-1, width)
    groups = tuple(tuple(int(r) for r in row) for row in rows.tolist())
    if len(dims) == 1:
        return Axis(groups, mesh.get_group(mesh.mesh_dim_names[dims[0]]))
    if width == runtime.size():
        return Axis(groups, None)
    key = ("mesh_axes",) + groups
    pgs = runtime.cached_groups(
        key, lambda: [dist.new_group(list(g)) for g in groups])
    r = runtime.rank()
    return Axis(groups, next(pg for g, pg in zip(groups, pgs) if r in g))


def _axis(axis):
    return world_axis() if axis is None else axis


def _reduce_scatter(out, inp, group=None, op=dist.ReduceOp.SUM):
    """The tiled reduce-scatter (member i of ``group`` gets block i of the
    sum), under the name this torch gives it: 2.13 deprecates
    ``reduce_scatter_tensor`` for ``reduce_scatter_single``."""
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, inp, op=op, group=group)
    return out


def _all_gather(out, inp, group=None):
    """The tiled all-gather (blocks in member order), by name as
    :func:`_reduce_scatter`."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=group)
    return out


def _scatter(flat, group, n):
    out = flat.new_empty(flat.shape[0] // n, *flat.shape[1:])
    return _reduce_scatter(out, flat.contiguous(), group)


def _gather(part, group, n, out=None):
    if out is None:
        out = part.new_empty(part.shape[0] * n, *part.shape[1:])
    return _all_gather(out, part.contiguous(), group)


def _divide(x, n):
    """``x / n`` in ``x``'s dtype (the JAX package's ``(x / n).astype``);
    an integer quotient truncates toward zero."""
    if x.is_floating_point() or x.is_complex():
        return x.div_(n)
    return x.div_(n, rounding_mode="trunc")


def reducescatter(tensor, average=False, axis=None):
    """Reduce across the ranks of ``axis`` (None: every rank), leaving
    each with its dim-0 stripe: rank i of the axis gets rows
    ``[i * d0 / n, (i + 1) * d0 / n)`` of the sum (``lax.psum_scatter(...,
    tiled=True)``). ``average`` divides by n, to a float for an integer
    tensor, as the JAX package's ``out / psum(1)`` does. Records
    ``reducescatter_jit``."""
    ax = _axis(axis)
    n = ax.size
    buf = _on_device(tensor)
    if buf.shape[0] % n:
        raise ValueError(f"reducescatter: dim 0 of size {buf.shape[0]} does "
                         f"not divide over {n} ranks")
    record_jit_traced("reducescatter_jit", _nbytes(buf))
    out = _scatter(buf, ax.group, n)
    return out / n if average else out


DEFAULT_RS_BUCKET_BYTES = 32 * 1024 * 1024


def _rs_bucket_bytes(bucket_bytes):
    if bucket_bytes is not None:
        return max(int(bucket_bytes), 1)
    from ..config import Config
    return Config.from_env().reduce_scatter_bucket


def _leaf_buckets(leaves, idxs, bucket_bytes):
    """Group leaf indices by dtype, then split each dtype run into buckets
    of at most ``bucket_bytes``: several bounded collectives instead of
    one monolith (or thousands of slivers)."""
    by_dtype = {}
    for i in idxs:
        by_dtype.setdefault(leaves[i].dtype, []).append(i)
    buckets = []
    for group in by_dtype.values():
        cur, cur_bytes = [], 0
        for i in group:
            nb = _nbytes(leaves[i])
            if cur and cur_bytes + nb > bucket_bytes:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nb
        if cur:
            buckets.append(cur)
    return buckets


def bucketed_reducescatter_allgather(tensors, average=True,
                                     bucket_bytes=None, axis=None):
    """Allreduce-equivalent exchange of a list of tensors as bucketed
    reduce-scatter + all-gather: each bucket (:func:`_leaf_buckets`,
    ``bucket_bytes`` default HOROVOD_REDUCE_SCATTER_BUCKET) is flattened,
    zero-padded to a multiple of n, reduce-scattered (each rank sums 1/n
    of it), averaged, and all-gathered back. Equal to
    :func:`grouped_allreduce` up to the sum's order. Records one
    ``reducescatter_jit`` and one ``allgather_jit`` a bucket. Returns the
    exchanged tensors in order."""
    leaves = [_on_device(t) for t in tensors]
    if not leaves:
        return []
    ax = _axis(axis)
    n = ax.size
    out = list(leaves)
    for idxs in _leaf_buckets(leaves, range(len(leaves)),
                              _rs_bucket_bytes(bucket_bytes)):
        flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
        size = flat.shape[0]
        pad = -size % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        record_jit_traced("reducescatter_jit", _nbytes(flat))
        shard = _scatter(flat, ax.group, n)
        if average:
            shard = _divide(shard, n)
        record_jit_traced("allgather_jit", _nbytes(shard))
        full = _gather(shard, ax.group, n)
        pos = 0
        for i in idxs:
            sz = leaves[i].numel()
            out[i] = full[pos:pos + sz].view(leaves[i].shape)
            pos += sz
    return out


# ------------------------------------------------------------- DCN staging
#
# One mesh axis of n ranks viewed as n / local hosts of local ranks (rank
# r of the axis = h * local + l): the exchange runs in two tiers, within
# each host (ICI in the JAX package; NVLink within an H100 node) at full
# width, then across hosts (DCN; the network between nodes), optionally
# compressed (bf16, or int8 on a scale shared by the group) with an
# error-feedback residual the caller carries. The tiers are process
# groups built once a session (:func:`_stage_groups`).

def dcn_index_groups(n, local):
    """(ici_groups, dcn_groups) for ``n`` ranks laid out as
    ``n // local`` hosts of ``local`` ranks. ICI group h =
    [h*local, (h+1)*local); DCN group l = [l, local+l, 2*local+l, ...]
    (one member per host, ordered by host)."""
    hosts = n // local
    ici = [list(range(h * local, (h + 1) * local)) for h in range(hosts)]
    dcn = [list(range(l, n, local)) for l in range(local)]
    return ici, dcn


def normalize_dcn_local_size(n, local=0):
    """Effective ICI-group size for DCN staging over ``n`` ranks.

    0/None asks the config (HOROVOD_DCN_LOCAL_SIZE), then the runtime's
    launcher-provided local size (ranks a host). Values that cannot tile
    the axis (non-dividing, out of range) normalize to ``n``: a single
    full-precision ICI stage, i.e. staging disabled."""
    if not local:
        from ..config import Config
        local = Config.from_env().dcn_local_size
    if not local:
        local = runtime.local_size() if runtime.is_initialized() else n
    local = int(local)
    if local <= 0 or local > n or n % local:
        return n
    return local


def _stage_groups(ax, local):
    """This rank's (ici, dcn) process groups for ``ax`` laid out as hosts
    of ``local`` ranks: built for every group of the axis, on every rank
    in the same order, once a session (``runtime.cached_groups``). A
    one-member tier has no group (None)."""
    def build():
        ici_idx, dcn_idx = dcn_index_groups(len(ax.groups[0]), local)
        me, mine = runtime.rank(), [None, None]
        for ranks in ax.groups:
            for tier, lists in enumerate((ici_idx, dcn_idx)):
                for idx in lists:
                    members = [ranks[i] for i in idx]
                    if len(members) < 2:
                        continue
                    pg = dist.new_group(members)
                    if me in members:
                        mine[tier] = pg
        return tuple(mine)
    return runtime.cached_groups(("dcn", ax.groups, int(local)), build)


def dcn_sigma(axis=None, local=None):
    """This rank's stripe-owner index after a staged reduce-scatter.

    Staging permutes ownership: rank r = (h, l) of the axis ends up
    holding flat segment (l*H + h), not segment r. Identity when staging
    is off (local == n) and, by the same formula, when every rank is its
    own host (local == 1). Parameter-stripe slicing and
    ``shard_params``/``unshard_params`` use this index so they agree
    with the scatter layout."""
    ax = _axis(axis)
    n, r = ax.size, ax.index()
    if local is None or local >= n or n % local:
        return r
    hosts = n // local
    return (r % local) * hosts + r // local


def _record_stage(stage, wire_bytes, raw_bytes):
    """Per-stage wire accounting (hvd_wire_stage_bytes_total / _raw_),
    once a call, so wire/raw is the exact compression factor."""
    from .. import metrics
    if not tracing():
        return
    metrics.WIRE_STAGE_BYTES.labels(stage=stage).inc(int(wire_bytes))
    metrics.WIRE_STAGE_RAW_BYTES.labels(stage=stage).inc(int(raw_bytes))


def dcn_staged_psum_scatter(flat, axis=None, local=None, dcn_compression="",
                            residual=None):
    """Reduce-scatter ``flat`` (length divisible by the axis size n) in
    two tiers: a full-width reduce-scatter within each ICI group, then a
    reduce-scatter across hosts (the DCN hop), optionally compressed.

    Returns ``(stripe, new_residual)``: ``stripe`` is this rank's 1/n
    segment of the global sum, the one at offset ``dcn_sigma(...) *
    (len(flat) // n)``, and ``new_residual`` the error-feedback carry of
    a lossy DCN hop (None when the hop is lossless or absent). Each rank
    adds last step's residual to its DCN-stage input, sends the
    compressed value and keeps the quantization error, so the next step
    corrects it. ``residual``/``new_residual`` have the ICI chunk's
    shape (``len(flat) // local``,) and belong in the optimizer's state.

    int8 quantizes on a scale shared by the DCN group (an all-reduce
    ``MAX`` of the max-abs, / 127), so every rank's codes lie on one grid
    and their sum dequantizes exactly; the codes are summed as int32 (H
    values in [-127, 127] cannot overflow), while the wire accounting
    records the 8-bit width. With staging off (``local >= n``) this is
    one plain reduce-scatter."""
    ax = _axis(axis)
    n = ax.size
    if local is None:
        local = n
    if flat.shape[0] % n:
        raise ValueError(
            f"dcn_staged_psum_scatter needs len(flat) % n == 0; got "
            f"{flat.shape[0]} over {n} ranks — pad before calling")
    comp = dcn_compression or "none"
    if local >= n or n % local:
        # a single full-precision stage: the whole exchange is ICI
        _record_stage("ici", _nbytes(flat), _nbytes(flat))
        record_jit_traced("reducescatter_jit", _nbytes(flat))
        with record_function("hvd_ici"):
            return _scatter(flat, ax.group, n), None
    ici, dcn = _stage_groups(ax, local)
    hosts = n // local
    if local > 1:
        _record_stage("ici", _nbytes(flat), _nbytes(flat))
        record_jit_traced("reducescatter_jit", _nbytes(flat))
        with record_function("hvd_ici"):
            chunk = _scatter(flat, ici, local)
    else:
        chunk = flat
    raw = _nbytes(chunk)
    elems = chunk.shape[0]
    if comp == "none":
        _record_stage("dcn", raw, raw)
        record_jit_traced("reducescatter_jit", raw)
        with record_function("hvd_dcn"):
            return _scatter(chunk, dcn, hosts), None
    e = chunk if residual is None else chunk + residual.to(chunk.dtype)
    if comp == "bf16":
        wire = e.to(torch.bfloat16)
        new_residual = e - wire.to(e.dtype)
        _record_stage("dcn", elems * 2, raw)
        record_jit_traced("reducescatter_jit", elems * 2)
        with record_function("hvd_dcn"):
            stripe = _scatter(wire, dcn, hosts)
        return stripe.to(e.dtype), new_residual
    if comp == "int8":
        amax = e.abs().max().reshape(1)
        with record_function("hvd_dcn"):
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=dcn)
        scale = Int8Compressor.scale_for(amax[0])
        codes = Int8Compressor.quantize(e, scale)
        new_residual = e - (codes * scale).to(e.dtype)
        _record_stage("dcn", elems, raw)
        record_jit_traced("reducescatter_jit", elems)
        with record_function("hvd_dcn"):
            summed = _scatter(codes.to(torch.int32), dcn, hosts)
        return (summed.to(scale.dtype) * scale).to(e.dtype), new_residual
    raise ValueError(
        f"unknown DCN compression {dcn_compression!r} (expected '', "
        "'none', 'bf16' or 'int8')")


def dcn_staged_all_gather(stripe, axis=None, local=None, dcn_compression="",
                          out=None):
    """Reassemble the flat vector from per-rank stripes laid out by
    :func:`dcn_staged_psum_scatter`: gather across hosts first (the DCN
    hop, in bf16 on the wire when compression is on; every rank receives
    the same rounded values, so this is transport rounding, not a source
    of divergence), then within each ICI group at full width. With
    staging off this is one plain all-gather, into ``out`` where
    given."""
    ax = _axis(axis)
    n = ax.size
    if local is None:
        local = n
    if local >= n or n % local:
        _record_stage("ici", _nbytes(stripe), _nbytes(stripe))
        record_jit_traced("allgather_jit", _nbytes(stripe))
        with record_function("hvd_ici"):
            return _gather(stripe, ax.group, n, out)
    ici, dcn = _stage_groups(ax, local)
    comp = dcn_compression or "none"
    raw = _nbytes(stripe)
    if comp == "none":
        wire = stripe
        _record_stage("dcn", raw, raw)
        record_jit_traced("allgather_jit", raw)
    else:
        wire = stripe.to(torch.bfloat16)
        _record_stage("dcn", stripe.shape[0] * 2, raw)
        record_jit_traced("allgather_jit", stripe.shape[0] * 2)
    with record_function("hvd_dcn"):
        chunk = _gather(wire, dcn, n // local).to(stripe.dtype)
    if local > 1:
        _record_stage("ici", _nbytes(chunk), _nbytes(chunk))
        record_jit_traced("allgather_jit", _nbytes(chunk))
        with record_function("hvd_ici"):
            chunk = _gather(chunk, ici, local)
    if out is not None:
        return out.copy_(chunk)
    return chunk


def hierarchical_allreduce(tensor, ici_axis, dcn_axis, average=True,
                           mesh=None):
    """Two-level all-reduce: reduce-scatter over the ICI tier, all-reduce
    over the DCN tier, all-gather back over ICI (the reference's
    ``NCCLHierarchicalAllreduce``). The axes are :class:`Axis` values or
    names of ``mesh`` (e.g. :func:`~horovod_tpu_torch.parallel.mesh.
    hierarchical_mesh`'s ``"local"`` and ``"cross"``). A length that the
    ICI size does not divide is zero-padded before the scatter and
    sliced back after the gather. ``average`` divides by the product of
    both sizes (to a float for an integer tensor). Records one
    ``allreduce_jit`` of the tensor's bytes."""
    if isinstance(ici_axis, str):
        ici_axis = mesh_axis(mesh, ici_axis)
    if isinstance(dcn_axis, str):
        dcn_axis = mesh_axis(mesh, dcn_axis)
    buf = _on_device(tensor)
    record_jit_traced("allreduce_jit", _nbytes(buf))
    flat = buf.reshape(-1)
    size = flat.shape[0]
    ici = ici_axis.size
    padded = -(-size // ici) * ici
    if padded != size:
        flat = torch.cat([flat, flat.new_zeros(padded - size)])
    shard = _scatter(flat, ici_axis.group, ici)
    dist.all_reduce(shard, group=dcn_axis.group)
    if average:
        shard = shard / (ici * dcn_axis.size)
    out = _gather(shard, ici_axis.group, ici)
    return out[:size].reshape(buf.shape)
