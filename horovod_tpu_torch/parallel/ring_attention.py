"""Ring attention: exact attention over a sequence-parallel axis, and the
single-device numerics baseline.

Counterpart of horovod_tpu/parallel/ring_attention.py. The sequence is
cut into ``n`` contiguous shards; shard i holds positions
[i*S_local, (i+1)*S_local). Each shard keeps its queries and streams the
K/V shards around a ring, merging each visiting tile's partial result
exactly through its log-sum-exp. The backward re-rotates the ring,
recomputing each tile from the saved global lse, and dK/dV travel with
their K/V shard until they come home.

The ring axis (:class:`RingAxis`) is the counterpart of the mesh axis
``sp`` and of ``lax.ppermute``. It comes in two forms:

- **over a process group**: one shard per rank, and a shift is a
  ``torch.distributed.batch_isend_irecv`` to the next rank (NCCL across
  cards, gloo on the CPU);
- **local**: all ``n`` shards live in one process on one device, each
  ring step runs for every local shard, and a shift rotates a Python
  list. This is how one card runs the sequence-parallel program (NCCL
  refuses two ranks on one card, and gloo sends CPU tensors only), as the
  JAX package's tests run ``sp`` over virtual devices of one host.

The ring code is written once, over the local shard indices, so both
forms run the same tile calls in the same order.
"""

import math

import torch
import torch.distributed as dist

NEG_INF = -1e30


def gqa_group(h_q, h_kv, h_v=None):
    """Query-heads-per-kv-head ratio with validation; 1 = plain MHA."""
    if h_v is not None and h_v != h_kv:
        raise ValueError(
            f"K and V must carry the same head count (got K={h_kv}, "
            f"V={h_v})")
    if h_q == h_kv:
        return 1
    if h_q % h_kv != 0:
        raise ValueError(
            f"GQA needs n_q_heads ({h_q}) divisible by n_kv_heads "
            f"({h_kv})")
    return h_q // h_kv


def f32_scale(d):
    """``1 / sqrt(d)`` as the JAX package computes it in f32
    (``1.0 / jnp.sqrt(d).astype(jnp.float32)``)."""
    return torch.tensor(1.0) / torch.sqrt(torch.tensor(float(d)))


def dense_attention(q, k, v, causal=True, scale=None, window=None):
    """Exact attention, q (B, S, H, D) and k/v (B, S, H_kv, D) with
    H % H_kv == 0; returns (B, S, H, D) in q's dtype.

    Mirrors the JAX function op for op: the q.k product is taken in f32
    from the input values (``preferred_element_type=f32``), then scaled;
    masked scores are filled with ``NEG_INF``; the softmax runs in f32;
    p is cast to v's dtype before the p.v product, which accumulates in
    f32."""
    rep = gqa_group(q.shape[2], k.shape[2], v.shape[2])
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = q.shape[1]
    if scale is None:
        # a Python number (f32's value): a CUDA graph captures no host copy
        scale = float(f32_scale(q.shape[3]))
    s_ = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        if window is not None:
            mask = mask & (pos[:, None] - pos[None, :] < window)
        s_ = torch.where(mask, s_, NEG_INF)
    elif window is not None:
        raise ValueError("window requires causal=True")
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


class RingAxis:
    """The sequence-parallel ring: ``size`` shards, of which this process
    holds ``shards`` (global indices, in order): all of them
    (:meth:`local`), or one, this rank's, of a process group
    (:meth:`over`)."""

    def __init__(self, size, shards, group=None):
        shards = tuple(int(i) for i in shards)
        if group is None:
            ok = size >= 1 and shards == tuple(range(size))
        else:
            ok = len(shards) == 1 and 0 <= shards[0] < size
        if not ok:
            raise ValueError(
                f"a ring of {size} keeps all its shards in one process, or "
                f"one shard a rank of a process group; got shards {shards}")
        self.size, self.shards, self.group = int(size), shards, group
        self.distributed = group is not None

    @classmethod
    def local(cls, size):
        """All ``size`` shards in this process, on one device."""
        return cls(size, range(size))

    @classmethod
    def over(cls, group=None):
        """One shard per rank of ``group`` (default: the world group of
        ``torch.distributed``); this rank holds shard ``rank``."""
        if group is None:
            group = dist.group.WORLD
        return cls(dist.get_world_size(group), (dist.get_rank(group),), group)

    def __repr__(self):
        form = "over a process group" if self.distributed else "local"
        return f"RingAxis(size={self.size}, shards={self.shards}, {form})"

    def shift(self, blocks, hops=1):
        """``lax.ppermute`` over the ring: ``blocks`` holds one list of
        tensors per local shard; shard i receives the tensors of shard
        ``i - hops``. Returns the blocks each local shard now holds."""
        hops %= self.size
        if hops == 0:
            return blocks
        if not self.distributed:
            n = self.size
            return [blocks[(i - hops) % n] for i in range(n)]
        return [self._send_recv(blocks[0], hops)]

    def refuse_capture(self):
        """Raise when a CUDA graph is being captured and this ring spans
        a process group: gloo moves tensors through the host and cannot
        be captured, and NCCL needs a card a rank."""
        if self.distributed and torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            raise NotImplementedError(
                "a sequence- or pipeline-parallel step over a process "
                "group cannot be captured in a CUDA graph yet (ROADMAP.md,"
                " \"Waiting for several cards\": the capture of a "
                "process-group SP or PP step); run it with "
                "HOROVOD_STEP_PROGRAM=0, or over RingAxis.local")

    def _send_recv(self, tensors, hops):
        self.refuse_capture()
        me = dist.get_rank(self.group)
        dst = dist.get_global_rank(self.group, (me + hops) % self.size)
        src = dist.get_global_rank(self.group, (me - hops) % self.size)
        tensors = [t.contiguous() for t in tensors]
        got = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, r in zip(tensors, got):
            ops.append(dist.P2POp(dist.isend, t, dst, self.group))
            ops.append(dist.P2POp(dist.irecv, r, src, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got


def _block_attn(q, k, v, mask, scale):
    """One (q-block, kv-block) tile: unnormalized partials (m, l, acc).
    q (B, Sq, H, D), k/v (B, Sk, H_kv, D) (GQA repeats per tile, so the
    ring streams the reduced K/V heads); mask (Sq, Sk), True = keep. The
    products run in f32 from the input values; p is cast to v's dtype
    before p.v."""
    rep = gqa_group(q.shape[2], k.shape[2], v.shape[2])
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m, l, acc


def _tile_masks(sq, sk, off, causal, window, device):
    """(Sq, Sk) keep-mask for a tile whose q rows sit ``off`` global
    positions after its k columns. None = all kept."""
    if not causal:
        return None
    dist_ = off + torch.arange(sq, device=device)[:, None] \
        - torch.arange(sk, device=device)[None, :]
    keep = dist_ >= 0
    if window is not None:
        keep = keep & (dist_ < window)
    return keep


def _tile_bwd_math(q, k, v, do, lse, delta, off, causal, window, scale):
    """One tile's f32 gradient contributions (dq, dk, dv) from the ring's
    global lse and delta = rowsum(dO * O), dk/dv at the K/V head count.
    Masked entries are zeroed, so a tile outside the band gives exact
    zeros."""
    h_kv = k.shape[2]
    rep = gqa_group(q.shape[2], h_kv, v.shape[2])
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    do = do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _tile_masks(q.shape[1], k.shape[1], off, causal, window, q.device)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    if rep > 1:
        b, sk = dk.shape[0], dk.shape[1]
        dk = dk.reshape(b, sk, h_kv, rep, -1).sum(dim=3)
        dv = dv.reshape(b, sk, h_kv, rep, -1).sum(dim=3)
    return dq, dk, dv


def ring_attention(q, k, v, axis, causal=True, scale=None, impl="dense",
                   window=None):
    """Exact attention with K/V streamed around the ring ``axis``.

    Args:
      q, k, v: this process's shards, concatenated along the sequence:
        (B, len(axis.shards) * S_local, H, D) for q and H_kv heads for
        k/v (H % H_kv == 0; the ring streams the reduced K/V heads).
      axis: a :class:`RingAxis`.
      causal: causal masking in global positions.
      scale: attention scale, default 1/sqrt(D) (``impl="dense"`` only).
      impl: "dense" computes each tile unfused; "flash" runs the hand
        kernels per tile (ops/flash_attention.py): the static kernels for
        the diagonal and fully visible tiles, the band kernels for the
        visiting tiles under a window.
      window: sliding-window span in global positions (requires causal).
        Shards wholly outside the band never visit: the ring runs
        1 + ceil((window - 1) / S_local) steps instead of ``axis.size``.

    Returns (B, S, H, D) in q's dtype. The backward saves only q, k, v,
    out and lse, and recomputes each tile, so its memory does not grow
    with the ring.
    """
    if not isinstance(axis, RingAxis):
        raise TypeError(f"axis must be a RingAxis, got {type(axis).__name__}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if impl == "flash":
        if scale is not None:
            raise ValueError("impl='flash' uses the 1/sqrt(D) scale; "
                             "custom scale is only supported with 'dense'")
    elif impl != "dense":
        raise ValueError(f"unknown ring attention impl {impl!r}")
    gqa_group(q.shape[2], k.shape[2], v.shape[2])  # validate head counts
    n_local = len(axis.shards)
    if q.shape[1] % n_local != 0 or k.shape[1] != q.shape[1] \
            or v.shape[1] != q.shape[1]:
        raise ValueError(
            f"q, k and v must hold {n_local} equal shards of one sequence "
            f"length: got {q.shape[1]}, {k.shape[1]}, {v.shape[1]}")
    return _RingCore.apply(q, k, v, axis, causal,
                           None if scale is None else float(scale), impl,
                           window)


def _ring_steps(n, s_local, causal, window):
    """Ring steps needed: under a window, step t's tile (nearest pair
    distance (t-1)*S_local + 1) is dead once that distance reaches the
    window, and every shard computes the same bound."""
    if window is not None and causal:
        return min(n, max(1, 2 + (window - 2) // s_local))
    return n


def _split(x, axis):
    return list(x.chunk(len(axis.shards), dim=1))


def _merge(acc, lse, o_j, lse_j):
    """Fold a tile's (out, lse) into the running f32 (acc, lse)."""
    new_lse = torch.logaddexp(lse, lse_j)
    w_old = torch.exp(lse - new_lse).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_j - new_lse).transpose(1, 2)[..., None]
    return acc * w_old + o_j.float() * w_new, new_lse


def _ring_forward(qs, ks, vs, axis, causal, scale, impl, window):
    """Per local shard (out in q's dtype, lse (B, H, S_local) f32)."""
    from ..ops.flash_attention import _tile_lse, flash_band_fwd

    n = axis.size
    b, s_local, h, d = qs[0].shape
    steps = _ring_steps(n, s_local, causal, window)
    kv = [[k, v] for k, v in zip(ks, vs)]

    if impl == "flash":
        # Diagonal tile first (offset 0: the static kernel), then the
        # visiting tiles.
        accs, lses = [], []
        for q, k, v in zip(qs, ks, vs):
            o, lse = _tile_lse(q, k, v, causal, window)
            accs.append(o.float())
            lses.append(lse)
        for t in range(1, steps):
            kv = axis.shift(kv)
            for i, idx in enumerate(axis.shards):
                if causal and t > idx:
                    continue  # a wrapped source, wholly in the future
                k_blk, v_blk = kv[i]
                if causal and window is not None:
                    o, lse = flash_band_fwd(qs[i], k_blk, v_blk,
                                            t * s_local, window)
                else:
                    # fully visible: the unmasked static kernel
                    o, lse = _tile_lse(qs[i], k_blk, v_blk, False, None)
                accs[i], lses[i] = _merge(accs[i], lses[i], o, lse)
        return [a.to(q.dtype) for a, q in zip(accs, qs)], lses

    # dense tiles: online softmax, masks in global positions
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = qs[0].device
    m = [torch.full((b, h, s_local), NEG_INF, device=dev) for _ in qs]
    l = [torch.zeros((b, h, s_local), device=dev) for _ in qs]
    acc = [torch.zeros((b, s_local, h, d), device=dev) for _ in qs]
    for t in range(steps):
        if t > 0:
            kv = axis.shift(kv)
        for i, idx in enumerate(axis.shards):
            if causal and t > idx:
                continue  # every entry masked: no contribution
            if causal:
                # shard idx - t visits: its keys sit t shards back
                mask = _tile_masks(s_local, s_local, t * s_local, True,
                                   window, dev)
            else:
                mask = torch.ones((s_local, s_local), dtype=torch.bool,
                                  device=dev)
            bm, bl, bacc = _block_attn(qs[i], *kv[i], mask, scale)
            new_m = torch.maximum(m[i], bm)
            alpha = torch.exp(m[i] - new_m)
            beta = torch.exp(bm - new_m)
            l[i] = l[i] * alpha + bl * beta
            acc[i] = (acc[i] * alpha.transpose(1, 2)[..., None]
                      + bacc * beta.transpose(1, 2)[..., None])
            m[i] = new_m
    outs, lses = [], []
    for q, m_i, l_i, a_i in zip(qs, m, l, acc):
        l_i = torch.clamp(l_i, min=1e-30)
        outs.append((a_i / l_i.transpose(1, 2)[..., None]).to(q.dtype))
        lses.append(m_i + torch.log(l_i))
    return outs, lses


def _ring_backward(qs, ks, vs, outs, lses, gs, axis, causal, scale, impl,
                   window):
    """Blockwise backward: re-rotate the ring, recomputing each tile from
    the saved global lse; dK/dV accumulators travel with their K/V shard
    and come home after the last step. Per local shard (dq, dk, dv) in
    the inputs' dtypes."""
    from ..ops.flash_attention import _tile_bwd_dispatch

    n = axis.size
    s_local, d = qs[0].shape[1], qs[0].shape[3]
    steps = _ring_steps(n, s_local, causal, window)
    scale_d = scale if scale is not None else 1.0 / math.sqrt(d)
    # delta = rowsum(dO * O): one pass, shared by every tile's recompute.
    deltas = [(g.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
              for g, o in zip(gs, outs)]

    def tile_bwd(i, k_blk, v_blk, off, tile_causal, tile_window):
        # off None marks the static offset-0 tiles (the diagonal and the
        # fully visible ones), which take the static kernels.
        if impl == "flash":
            return _tile_bwd_dispatch(qs[i], k_blk, v_blk, gs[i], lses[i],
                                      deltas[i], off, tile_causal,
                                      tile_window)
        return _tile_bwd_math(qs[i], k_blk, v_blk, gs[i], lses[i],
                              deltas[i], 0 if off is None else off,
                              tile_causal, tile_window, scale_d)

    dq, dkv = [], []
    for i in range(len(qs)):
        dq_i, dk_i, dv_i = tile_bwd(i, ks[i], vs[i], None, causal, window)
        dq.append(dq_i)
        dkv.append([dk_i, dv_i])
    kv = [[k, v] for k, v in zip(ks, vs)]
    for t in range(1, steps):
        kv = axis.shift(kv)
        dkv = axis.shift(dkv)
        for i, idx in enumerate(axis.shards):
            if causal:
                # Visiting live tiles sit a whole shard or more in the
                # past: fully visible without a window, band tiles with
                # one. Wrapped sources (t > idx) are wholly in the future
                # and contribute exact zeros.
                if t > idx:
                    continue
                if window is None:
                    grads = tile_bwd(i, *kv[i], None, False, None)
                else:
                    # the JAX package's where(t > idx, t - n, t) * S_local,
                    # on the live side
                    grads = tile_bwd(i, *kv[i], t * s_local, True, window)
            else:
                grads = tile_bwd(i, *kv[i], None, False, None)
            dq[i] = dq[i] + grads[0]
            dkv[i] = [dkv[i][0] + grads[1], dkv[i][1] + grads[2]]
    if steps > 1:
        # After step t the dK/dV of shard idx sit at shard idx + t: one
        # shift of 1 - steps hops brings them home (the JAX package's last
        # in-scan permute and, for a window-pruned ring, its extra one).
        dkv = axis.shift(dkv, hops=1 - steps)
    return ([x.to(q.dtype) for x, q in zip(dq, qs)],
            [x[0].to(k.dtype) for x, k in zip(dkv, ks)],
            [x[1].to(v.dtype) for x, v in zip(dkv, vs)])


class _RingCore(torch.autograd.Function):
    """The JAX package's custom VJP ``_ring_core``: the forward saves q,
    k, v, out and lse of the local shards, O(S_local) each; the backward
    re-rotates the ring."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale, impl, window):
        outs, lses = _ring_forward(_split(q, axis), _split(k, axis),
                                   _split(v, axis), axis, causal, scale,
                                   impl, window)
        out, lse = torch.cat(outs, dim=1), torch.cat(lses, dim=2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (axis, causal, scale, impl, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        axis = ctx.args[0]
        # each shard's lse once as the dense (B, H, S_local) the kernels
        # read, not a strided chunk every tile would copy again
        lses = [x.contiguous() for x in lse.chunk(len(axis.shards), dim=2)]
        dq, dk, dv = _ring_backward(
            _split(q, axis), _split(k, axis), _split(v, axis),
            _split(out, axis), lses, _split(g.contiguous(), axis),
            *ctx.args)
        return (torch.cat(dq, dim=1), torch.cat(dk, dim=1),
                torch.cat(dv, dim=1), None, None, None, None, None)
