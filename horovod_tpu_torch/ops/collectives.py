"""Collectives over the runtime's process group.

Counterpart of horovod_tpu/ops/collectives.py, carrying what the
training slice needs: :func:`allreduce` (average or sum),
:func:`grouped_allreduce` (one flat buffer per dtype),
:func:`allgather` (equal shapes), :func:`broadcast` and the bucket
scheduler :func:`exchange_bucket_plan`, copied from the JAX package.
Each function runs on ``torch.distributed`` and records every execution
in the session's stats (stats.py): op, wire bytes, time from launch to
completion. ``reducescatter``, ``alltoall`` and the DCN stages wait for
ROADMAP.md, Queue 1 items 3 and 11.

In the JAX package these run inside a mapped program over a mesh axis;
here each rank is a process and calls them eagerly, in the same order on
every rank, as with the reference Horovod. An average is the sum over
ranks divided by ``size()``, taken after decompression.
"""

import time

import torch
import torch.distributed as dist

from .. import runtime
from ..stats import record_jit_traced
from .compression import Compression


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

    Inside a CUDA graph capture (ops/step_program.py) the exchange takes
    no events, which would become graph nodes with no time to read: it
    records as ``<op>_jit`` once, at the capture
    (stats.record_jit_traced)."""

    def __init__(self, op):
        st = runtime.live_state()
        self._op, self._stats = op, st.stats
        self._cuda = st.device.type == "cuda"
        self._captured = (self._cuda
                          and torch.cuda.is_current_stream_capturing())
        if not self._cuda:
            self._t0 = time.perf_counter()
        elif not self._captured:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._works, self._nbytes = [], 0

    def launch(self, fn, nbytes):
        """Start one collective of ``nbytes`` wire bytes: ``fn`` returns
        its async work."""
        self._works.append(fn())
        self._nbytes += nbytes
        return self

    def wait(self):
        """Wait for every launched collective (on a card: order the
        caller's stream after them)."""
        for work in self._works:
            work.wait()

    def done(self):
        """Stop the clock and record the execution."""
        if self._captured:
            record_jit_traced(f"{self._op}_jit", self._nbytes)
        elif self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._stats.record_events(self._op, self._nbytes, self._start,
                                      end)
        else:
            self._stats.record(self._op, self._nbytes,
                               time.perf_counter() - self._t0)

    def finish(self):
        self.wait()
        self.done()
        return self


def _on_device(tensor):
    """``tensor`` on the runtime's device, contiguous (a copy when it was
    elsewhere: NCCL takes only card tensors)."""
    dev = runtime.live_state().device
    return tensor.to(dev).contiguous()


def start_allreduce(buf, exchange=None):
    """Launch an in-place sum of ``buf`` (on the runtime's device,
    contiguous) over every rank, as part of ``exchange`` (default: a new
    one); returns the exchange."""
    if exchange is None:
        exchange = Exchange("allreduce")
    return exchange.launch(lambda: dist.all_reduce(buf, async_op=True),
                           _nbytes(buf))


def _average(summed, n):
    if summed.is_floating_point() or summed.is_complex():
        return summed.div_(n)
    return summed.div_(n, rounding_mode="trunc")


def allreduce(tensor, average=True, compression=Compression.none):
    """Sum or average ``tensor`` over every rank; returns a new tensor on
    the runtime's device. ``compression`` narrows the wire (fp16/bf16)
    and restores the dtype after the sum."""
    wire, ctx = compression.compress(tensor)
    buf = _on_device(wire).clone()
    start_allreduce(buf).finish()
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


def grouped_allreduce(tensors, average=True, compression=Compression.none):
    """Allreduce a list of tensors as one group: one fused all-reduce per
    dtype over the concatenated tensors (the reference's tensor fusion).
    Returns the reduced tensors in order."""
    compressed = [compression.compress(_on_device(t)) for t in tensors]
    wires = [w for w, _ in compressed]
    groups = flatten_by_dtype(wires)
    exchange = Exchange("allreduce")
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


def allgather(tensor):
    """Every rank's ``tensor`` concatenated along dim 0, in rank order
    (equal shapes on every rank)."""
    buf = _on_device(tensor)
    parts = [torch.empty_like(buf) for _ in range(runtime.size())]
    Exchange("allgather").launch(
        lambda: dist.all_gather(parts, buf, async_op=True),
        _nbytes(buf)).finish()
    return torch.cat(parts, dim=0)


def broadcast_(tensor, root_rank):
    """Overwrite ``tensor`` in place with ``root_rank``'s value; returns
    it. A tensor off the runtime's device travels through a copy."""
    buf = _on_device(tensor)
    Exchange("broadcast").launch(
        lambda: dist.broadcast(buf, src=root_rank, async_op=True),
        _nbytes(buf)).finish()
    if buf.data_ptr() != tensor.data_ptr():
        tensor.copy_(buf)
    return tensor


def broadcast(tensor, root_rank):
    """``root_rank``'s value of ``tensor`` on every rank, as a new tensor
    on the runtime's device."""
    return broadcast_(_on_device(tensor).clone(), root_rank)


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
