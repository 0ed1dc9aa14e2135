"""Ulysses sequence parallelism: head <-> sequence re-shard by all-to-all.

Counterpart of horovod_tpu/parallel/ulysses.py. Where ring attention
(parallel/ring_attention.py) keeps the heads whole and streams K/V
shards around the ring, Ulysses (DeepSpeed-Ulysses, Jacobs et al.,
2023) re-shards: one all-to-all gathers the sequence and scatters the
heads, each shard runs ordinary full-sequence attention over H/n heads
(any single-device kernel, the flash kernels included; no log-sum-exp
merging), and the inverse all-to-all restores the sequence shards. It
needs ``n_heads % n == 0`` and ``n_kv_heads % n == 0``.

The axis is a :class:`~horovod_tpu_torch.parallel.ring_attention.RingAxis`
(``ShardAxes.sp``), in its two forms:

- **over a process group**: this rank holds one sequence shard; the
  re-shard is the port's tiled all-to-all over the group
  (ops/collectives.py ``alltoall``: split the heads, concatenate the
  sequence), differentiable, its backward the inverse all-to-all, as
  ``lax.all_to_all`` transposes;
- **local**: every shard lives in this process, so the whole sequence
  is here already, and shard j's re-shard is the head slice
  ``[:, :, j*H/n:(j+1)*H/n]`` of q (and of k and v at H_kv/n heads):
  views, moved nowhere. The attention runs once per shard at H/n
  heads, as each rank would launch it, and the outputs are concatenated
  over the heads.

Under grouped-query attention each shard holds whole GQA groups (query
head h reads K/V head ``h // (H / H_kv)``), so the head slices of q and
of k/v line up.
"""

import torch

from ..ops.collectives import alltoall
from .ring_attention import RingAxis, dense_attention


def _check_heads(heads, kv_heads, n):
    if heads % n != 0:
        raise ValueError(
            f"ulysses_attention requires n_heads ({heads}) divisible by "
            f"the 'sp' axis size ({n})")
    if kv_heads % n != 0:
        raise ValueError(
            f"ulysses_attention requires n_kv_heads ({kv_heads}) "
            f"divisible by the 'sp' axis size ({n}) — grouped-"
            f"query K/V re-shard through the same all-to-all")


def ulysses_attention(q, k, v, axis, causal=True, scale=None, attn_fn=None):
    """Exact attention with head <-> sequence re-sharding over ``axis``.

    Args:
      q, k, v: this process's sequence, (B, S_here, H, D) for q and H_kv
        heads for k/v: one shard of the global sequence over a process
        group, the whole sequence (all ``axis.size`` shards) on a local
        axis. H and H_kv must be divisible by the axis size.
      axis: a :class:`RingAxis`.
      causal: causal masking. The attention sees the whole sequence, so
        positions are global with no per-shard offset.
      scale: attention scale, default 1/sqrt(D).
      attn_fn: ``f(q, k, v, causal=..., scale=...)`` computing
        full-sequence attention on (B, S, H/n, D), e.g. the flash
        kernels; default :func:`dense_attention`.

    Returns (B, S_here, H, D) in q's dtype.
    """
    if not isinstance(axis, RingAxis):
        raise TypeError(f"axis must be a RingAxis, got {type(axis).__name__}")
    n = axis.size
    _check_heads(q.shape[2], k.shape[2], n)
    if attn_fn is None:
        attn_fn = dense_attention
    if not axis.distributed:
        hq, hkv = q.shape[2] // n, k.shape[2] // n
        outs = [attn_fn(q[:, :, j * hq:(j + 1) * hq],
                        k[:, :, j * hkv:(j + 1) * hkv],
                        v[:, :, j * hkv:(j + 1) * hkv],
                        causal=causal, scale=scale) for j in range(n)]
        return torch.cat(outs, dim=2).to(q.dtype)
    axis.refuse_capture()

    def to_seq(x):
        # (B, S/n, H, D) -> (B, S, H/n, D): scatter heads, gather sequence
        return alltoall(x, axis.group, split_axis=2, concat_axis=1)

    out = attn_fn(to_seq(q), to_seq(k), to_seq(v), causal=causal,
                  scale=scale)
    # (B, S, H/n, D) -> (B, S/n, H, D): the inverse re-shard
    return alltoall(out.to(q.dtype), axis.group, split_axis=1,
                    concat_axis=2)


__all__ = ["ulysses_attention"]
