"""Pipeline parallelism: the GPipe and 1F1B schedules over a pp axis.

Counterpart of horovod_tpu/parallel/pipeline.py. Each index of the pp
axis is one stage; activations move stage to stage by a shift of the
axis (the reference's ``lax.ppermute``). The axis is a
:class:`~horovod_tpu_torch.parallel.ring_attention.RingAxis`, in its two
forms:

- **local**: every stage lives in this process (how one card runs a
  pipeline, as the JAX package's tests run ``pp`` over virtual devices);
  a shift hands each stage's output to the next stage in a Python list;
- **over a process group**: one stage a rank; a shift is a send to the
  next rank and a receive from the previous one.

Which slots compute. The reference runs every (stage, slot) of its
schedules, with the inactive ones masked to exact zeros, because a
collective inside a branch only part of the mesh enters would hang XLA's
rendezvous. Torch has no rendezvous, so the port skips a (stage, slot)
whose activity is false wherever it can keep every send paired with its
receive, and gets the reference's answer, since the masked slots
contribute exact zeros:

- **local form, both schedules, and 1F1B over a process group**: only
  active slots compute. A stage sends in a slot only when the slot
  algebra says it produced there, and the neighbour receives by the same
  rule. A tensor, sequence or expert group lies within one pp
  coordinate, so its ranks share every slot's activity and enter its
  collectives together. So on one card GPipe runs each stage once a
  microbatch forward and once backward, and 1F1B runs it twice forward
  (the forward phase and the backward phase's recompute) and once
  backward.
- **GPipe over a process group**: every stage computes every slot,
  masked, as the reference does. GPipe is differentiated by autograd,
  and the shift's backward is the opposite shift on every rank: the
  masked schedule chains each rank's shifts through its stage, so every
  rank runs the shifts' backwards in the same order.

1F1B computes its gradients itself: its backward phase re-runs the
stage forward from the stashed input and takes ``torch.autograd.grad``
of it; do not differentiate through it.
"""

import torch
import torch.distributed as dist
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_structure, tree_unflatten)

from .ring_attention import RingAxis


def _check_axis(axis):
    if not isinstance(axis, RingAxis):
        raise TypeError(f"the pp axis must be a RingAxis, got "
                        f"{type(axis).__name__}")


def _take(inputs, i):
    return tree_map(lambda a: a[i], inputs)


class _Shift(torch.autograd.Function):
    """``lax.ppermute`` over a process group, differentiable: every rank
    sends its tensors ``hops`` ranks on and receives from ``hops``
    back; the backward is the opposite shift of the cotangents."""

    @staticmethod
    def forward(ctx, axis, hops, *tensors):
        ctx.axis, ctx.hops = axis, hops
        return tuple(axis.shift([list(tensors)], hops)[0])

    @staticmethod
    def backward(ctx, *grads):
        back = ctx.axis.shift([[g.contiguous() for g in grads]], -ctx.hops)
        return (None, None, *back[0])


def shift(axis, tree, hops=1):
    """A pytree of tensors moved ``hops`` stages on over the pp group
    ``axis`` (every rank at once), differentiable."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(list(_Shift.apply(axis, hops, *leaves)), spec)


def pipeline(stage_fn, inputs, axis, *, num_microbatches=None,
             inject_fn=None, collect_fn=None):
    """Run a GPipe fill-drain schedule: M microbatches over S stages in
    M + S - 1 steps, differentiable by autograd.

    Args:
      stage_fn: ``stage_fn(stage, x) -> y``: stage ``stage``'s (its index
        on the axis) transform of one microbatch activation (the same
        pytree structure in and out).
      inputs: ``(M, ...)`` stack (or pytree of stacks) of raw microbatch
        inputs; only stage 0 consumes it.
      axis: the pp :class:`RingAxis`.
      num_microbatches: M; defaults to ``inputs``' leading dimension.
      inject_fn: ``inject_fn(raw) -> x`` at stage 0 (identity if None).
      collect_fn: ``collect_fn(y, mb) -> out`` on the last stage's output
        of microbatch ``mb`` (identity if None).

    Returns the ``(M, ...)`` stack of collected outputs: the last stage's
    on a local axis; over a process group the last stage's rank holds
    them and the others zeros, as in the reference (reduce with
    :func:`last_stage_value`).
    """
    _check_axis(axis)
    n = axis.size
    m = num_microbatches or tree_leaves(inputs)[0].shape[0]
    inject = inject_fn or (lambda raw: raw)
    collect = collect_fn or (lambda y, mb: y)
    if axis.distributed:
        return _pipeline_masked(stage_fn, inputs, axis, m, inject, collect)
    outs = [None] * m
    recv = [None] * n
    for t in range(m + n - 1):
        sent = [None] * n
        for s in range(n):
            mb = t - s
            if not 0 <= mb < m:
                continue
            y = stage_fn(s, inject(_take(inputs, mb)) if s == 0 else recv[s])
            if s == n - 1:
                outs[mb] = collect(y, mb)
            else:
                sent[s] = y
        recv = axis.shift(sent)
    return tree_map(lambda *xs: torch.stack(xs), *outs)


def _flag(value, like):
    return torch.tensor(bool(value), device=tree_leaves(like)[0].device)


def _pipeline_masked(stage_fn, inputs, axis, m, inject, collect):
    """The reference's GPipe scan over a process group: every stage runs
    every step, masked by its activity (module docstring)."""
    n, sid = axis.size, axis.shards[0]
    with torch.no_grad():
        x_prev = tree_map(torch.zeros_like, inject(_take(inputs, 0)))
    outs = None
    steps = m + n - 1
    for t in range(steps):
        mb = t - sid
        active = 0 <= mb < m
        mb_c = min(max(mb, 0), m - 1)
        first = inject(_take(inputs, min(t, m - 1)))
        x_in = tree_map(lambda f, p: torch.where(_flag(sid == 0, f), f, p),
                        first, x_prev)
        y = stage_fn(sid, x_in)
        y = tree_map(lambda a: torch.where(_flag(active, a), a, 0), y)
        out = collect(y, mb_c)
        if outs is None:
            outs = [tree_map(torch.zeros_like, out) for _ in range(m)]
        write = active and sid == n - 1
        outs[mb_c] = tree_map(lambda o, b: torch.where(_flag(write, o), o, b),
                              out, outs[mb_c])
        if t < steps - 1:
            x_prev = shift(axis, y)
    return tree_map(lambda *xs: torch.stack(xs), *outs)


class _LastStage(torch.autograd.Function):
    """The sum over the pp group; the cotangent passes through. The
    reference's psum transposes to a psum, and ``shard_map``'s transpose
    of the replicated loss first divides its cotangent by the axis size:
    the two cancel, and each rank keeps its own paths' gradient."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def last_stage_value(x, axis):
    """The last stage's value on every stage: the masked sum over the
    pp group (the other stages hold zeros by construction in
    :func:`pipeline`); on a local axis :func:`pipeline` already returns
    the last stage's."""
    _check_axis(axis)
    if not axis.distributed:
        return x
    return _LastStage.apply(x, axis.group)


def _stage_params(tree, i, n, v):
    """Local stage ``i`` of ``n`` in this process of a stacked tree: the
    leading layer dim (V 1) or the stage dim of the (V, S, ...) layout
    cut in ``n`` blocks, as views. Over a process group (n 1) the rank
    holds its block already."""
    if n == 1:
        return tree
    dim = 0 if v == 1 else 1

    def cut(a):
        k = a.shape[dim] // n
        return a.narrow(dim, i * k, k)
    return tree_map(cut, tree)


def _chunk(tree, c, v):
    """One chunk's params of a stage's (V, ...) tree: ``a[c]``."""
    return tree if v == 1 else tree_map(lambda a: a[c], tree)


def _grad_leaf(a):
    return a.detach().requires_grad_()


def pipeline_1f1b(stage_fn, stage_params, shared_params, inputs, axis, *,
                  num_microbatches=None, inject_fn=None, loss_fn=None,
                  loss_replicas=1, num_chunks=1, stage_collectives=True):
    """1F1B (PipeDream-flush): forwards and backwards interleave in one
    lockstep loop of super-slots, so a stage stashes at most 2S - 1
    inputs (2S interleaved) instead of GPipe's M residual sets. The
    backward phase recomputes the stage forward from the stash and takes
    its vector-Jacobian product with ``torch.autograd.grad``; do not
    wrap this in autograd. The slot algebra (:func:`_slot_algebra`) is
    the reference's: slot u runs F(chunk c, microbatch g*S + r) on stage
    s at u = (g*V + c)*S + s + r, and B mirrored from V*S - 1.

    Args:
      stage_fn: ``stage_fn(chunk_params, x) -> y`` (same pytree in and
        out); ``chunk_params`` is one chunk's params of the stage.
      stage_params: the stacked stage parameters: on a local axis all
        stages' (leading dim S*L', or the (V, S, ...) layout), over a
        process group this rank's block (L', or (V, 1, ...)).
      shared_params: parameters every stage reads in ``inject_fn`` (stage
        0) and ``loss_fn`` (the last stage); their gradient is summed
        over the stages (the reference's psum over pp).
      inputs: ``(M, ...)`` stack of raw microbatch inputs.
      axis: the pp :class:`RingAxis`.
      inject_fn: ``inject_fn(shared_params, raw) -> x`` at the first
        virtual stage.
      loss_fn: ``loss_fn(shared_params, y, mb) -> scalar`` at the last
        virtual stage (required).
      loss_replicas: ranks computing an identical loss for each (stage,
        microbatch), such as a tensor-parallel group whose ``loss_fn``
        psums: the backward's seed, 1/M, is divided by it, and the caller
        sums the gradients of leaves replicated over those ranks.
      num_chunks: V, the interleaved virtual stages: stage s holds
        virtual stages {c*S + s}, and ``stage_params`` carries the
        (V, S, ...) layout.
      stage_collectives: the reference's switch between its masked
        uniform schedule (True) and its gated one (False). The port
        skips inactive slots either way (module docstring), so both run
        the gated schedule's work.

    Returns ``(loss, d_stage_params, d_shared_params)``: the mean loss
    over the microbatches on every stage, the gradients of that mean in
    ``stage_params``' layout and ``shared_params``'.
    """
    del stage_collectives  # the same schedule either way (docstring)
    _check_axis(axis)
    if loss_fn is None:
        raise TypeError("pipeline_1f1b needs a loss_fn: its backward "
                        "phase seeds from the last stage's loss")
    n = axis.size
    m_total = num_microbatches or tree_leaves(inputs)[0].shape[0]
    v = num_chunks
    num_slots, f_act, b_act = _slot_algebra(n, m_total, v)
    cap = stash_capacity(n, v)
    local = axis.shards
    nl = len(local)
    stages = [_stage_params(stage_params, i, nl, v) for i in range(nl)]
    d_sp = tree_map(torch.zeros_like, stage_params)
    d_stages = [_stage_params(d_sp, i, nl, v) for i in range(nl)]
    d_sh = tree_map(torch.zeros_like, shared_params)
    seed = 1.0 / (m_total * loss_replicas)

    def first_vs(s, c):
        return s == 0 and c == 0

    def last_vs(s, c):
        return s == n - 1 and c == v - 1

    def run(sp, sh, x_recv, s, mb, c):
        if first_vs(s, c):
            raw = _take(inputs, mb)
            x_recv = inject_fn(sh, raw) if inject_fn else raw
        return stage_fn(sp, x_recv)

    stash = [[[None] * cap for _ in range(v)] for _ in range(nl)]
    fwd_recv, bwd_recv = [None] * nl, [None] * nl
    loss_acc = None
    x_like = None
    if axis.distributed:
        with torch.no_grad():
            raw = _take(inputs, 0)
            x_like = inject_fn(shared_params, raw) if inject_fn else raw
    for u in range(num_slots):
        sent_f, sent_b = [None] * nl, [None] * nl
        # ---- forward phase: the stage on the received input, no graph
        for i, s in enumerate(local):
            active, c, mb = f_act(s, u)
            if not active:
                continue
            stash[i][c][mb % cap] = fwd_recv[i]
            with torch.no_grad():
                y = run(_chunk(stages[i], c, v), shared_params, fwd_recv[i],
                        s, mb, c)
            if not last_vs(s, c):
                sent_f[i] = y
        # ---- backward phase: recompute from the stash, then the vjp
        for i, s in enumerate(local):
            active, c, mb = b_act(s, u)
            if not active:
                continue
            sp = tree_map(_grad_leaf, _chunk(stages[i], c, v))
            sh = tree_map(_grad_leaf, shared_params)
            xr = stash[i][c][mb % cap]
            stash[i][c][mb % cap] = None
            xr = None if first_vs(s, c) else tree_map(_grad_leaf, xr)
            x_leaves = [] if xr is None else tree_leaves(xr)
            with torch.enable_grad():
                y = run(sp, sh, xr, s, mb, c)
                if last_vs(s, c):
                    loss = loss_fn(sh, y, mb)
                    outs, cots = [loss], [torch.full_like(loss, seed)]
                    inc = loss.detach().float()
                    loss_acc = inc if loss_acc is None else loss_acc + inc
                else:
                    outs = tree_leaves(y)
                    cots = tree_leaves(bwd_recv[i])
                # a leaf the stage did not touch (a dense stage's aux
                # after the first) carries no graph: its cotangent is lost
                pairs = [(o, g) for o, g in zip(outs, cots)
                         if o.requires_grad]
                wrt = tree_leaves(sp) + tree_leaves(sh) + x_leaves
                grads = torch.autograd.grad([o for o, _ in pairs], wrt,
                                            [g for _, g in pairs],
                                            allow_unused=True)
            n_sp, n_sh = len(tree_leaves(sp)), len(tree_leaves(sh))
            for acc, g in zip(tree_leaves(_chunk(d_stages[i], c, v))
                              + tree_leaves(d_sh), grads[:n_sp + n_sh]):
                if g is not None:
                    acc.add_(g)
            if not first_vs(s, c):
                sent_b[i] = tree_unflatten(
                    [torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads[n_sp + n_sh:], x_leaves)],
                    tree_structure(xr))
        # ---- the exchange: each buffer holds until its neighbour sends
        if axis.distributed:
            got_f, got_b = _exchange_1f1b(axis, sent_f[0], sent_b[0], u,
                                          f_act, b_act, x_like, last_vs,
                                          first_vs)
            got_f, got_b = [got_f], [got_b]
        else:
            got_f, got_b = axis.shift(sent_f), axis.shift(sent_b, -1)
        fwd_recv = [g if g is not None else r for g, r in zip(got_f, fwd_recv)]
        bwd_recv = [g if g is not None else r for g, r in zip(got_b, bwd_recv)]
    if loss_acc is None:
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(d_sp)[0].device)
    if axis.distributed:
        dist.all_reduce(loss_acc, group=axis.group)
        for g in tree_leaves(d_sh):
            dist.all_reduce(g, group=axis.group)
    return loss_acc / m_total, d_sp, d_sh


def _exchange_1f1b(axis, y, g_x, u, f_act, b_act, x_like, last_vs, first_vs):
    """One super-slot's sends and receives over the pp group: the forward
    output to the next stage and the input cotangent to the previous
    one, each only where the slot algebra says it was produced, so every
    rank posts exactly the receives its neighbours' sends need."""
    n, me = axis.size, axis.shards[0]
    nxt, prv = (me + 1) % n, (me - 1) % n
    a, c, _ = f_act(prv, u)
    want_f = a and not last_vs(prv, c)
    a, c, _ = b_act(nxt, u)
    want_b = a and not first_vs(nxt, c)
    ops, got_f, got_b = [], None, None

    def rank(i):
        return dist.get_global_rank(axis.group, i)

    axis.refuse_capture()
    if y is not None:
        ops += [dist.P2POp(dist.isend, t.contiguous(), rank(nxt), axis.group,
                           tag=1) for t in tree_leaves(y)]
    if want_f:
        got_f = tree_map(torch.empty_like, x_like)
        ops += [dist.P2POp(dist.irecv, t, rank(prv), axis.group, tag=1)
                for t in tree_leaves(got_f)]
    if g_x is not None:
        ops += [dist.P2POp(dist.isend, t.contiguous(), rank(prv), axis.group,
                           tag=2) for t in tree_leaves(g_x)]
    if want_b:
        got_b = tree_map(torch.empty_like, x_like)
        ops += [dist.P2POp(dist.irecv, t, rank(nxt), axis.group, tag=2)
                for t in tree_leaves(got_b)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got_f, got_b


def stash_capacity(num_stages, num_chunks=1):
    """The 1F1B stash ring's slots per chunk: at V 1, F(s, m) lives from
    super-slot s + m until B(s, m) at 2S - 2 - s + m, so at most 2S - 1
    are in flight; interleaved, F(m + 2S) lands at least 2 slots after
    B(m) read its slot, so 2S."""
    return (2 * num_stages - 1) if num_chunks == 1 else 2 * num_stages


def _slot_algebra(num_stages, m_total, v):
    """The interleaved-1F1B slot algebra, shared verbatim by the schedule
    (:func:`pipeline_1f1b`) and the pure cost model
    (:func:`interleaved_1f1b_cost`) — one source of truth, so the model
    cannot silently drift from the shipped schedule. All operations are
    plain ``% // & >= <`` arithmetic on Python ints.

    Returns ``(num_slots, f_activity, b_activity)`` where each activity
    fn maps ``(stage, slot) -> (active, chunk, microbatch)`` with
    UNCLIPPED indices (F(chunk c, microbatch g*S + r) runs on stage s at
    slot (g*v + c)*S + s + r; B mirrored from offset v*S - 1)."""
    g_last, r_last = divmod(m_total - 1, num_stages)
    num_slots = ((v * num_stages - 1)
                 + (g_last * v + v - 1) * num_stages
                 + (num_stages - 1) + r_last + 1)

    def f_activity(s, u):
        q = u - s
        r = q % num_stages
        w = q // num_stages
        c = w % v
        m = (w // v) * num_stages + r
        return (q >= 0) & (m < m_total), c, m

    def b_activity(s, u):
        q = u - (v * num_stages - 1) - (num_stages - 1 - s)
        r = q % num_stages
        w = q // num_stages
        c = v - 1 - (w % v)
        m = (w // v) * num_stages + r
        return (q >= 0) & (m < m_total), c, m

    return num_slots, f_activity, b_activity


def interleaved_1f1b_cost(num_stages, num_microbatches, num_chunks=1,
                          gated=False):
    """Modeled critical-path work of one :func:`pipeline_1f1b` run, in
    device-stage forward-equivalents (one V=1 forward phase = 1 unit, one
    backward = 2). Built on the SAME :func:`_slot_algebra` the schedule
    uses; wall time per slot is the mesh-wide max (stages sync at the
    exchanges). ``gated`` models slots whose inactive phases cost
    nothing (the port's schedule, and the reference's with
    ``stage_collectives=False``); ungated, every slot costs a forward
    and a backward phase.

    Returns ``(wall, ideal, bubble)`` where ``ideal = 3*M`` (the
    zero-bubble floor) and ``bubble = wall - ideal``.
    """
    s_n, v = num_stages, num_chunks
    num_slots, f_act, b_act = _slot_algebra(s_n, num_microbatches, v)
    unit = 1.0 / v
    wall = 0.0
    for u in range(num_slots):
        if gated:
            wall += unit * max(
                (1.0 if f_act(s, u)[0] else 0.0)
                + (2.0 if b_act(s, u)[0] else 0.0)
                for s in range(s_n))
        else:
            wall += unit * 3.0
    ideal = 3.0 * num_microbatches
    return wall, ideal, wall - ideal


def stack_layers(layer_list):
    """Stack a list of per-layer parameter trees into one tree with a
    leading layer dim; cut each stage's block with
    ``slice_param_shards`` and the pipelined specs."""
    return tree_map(lambda *xs: torch.stack(xs), *layer_list)


def unstack_layers(stacked):
    """Inverse of :func:`stack_layers`."""
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]


def apply_stacked_layers(block_fn, stacked_params, x):
    """Apply ``block_fn(layer_params, x) -> x`` over a stacked layer tree
    in layer order (the reference's ``lax.scan`` over the stack)."""
    for i in range(tree_leaves(stacked_params)[0].shape[0]):
        x = block_fn(tree_map(lambda a, i=i: a[i], stacked_params), x)
    return x
