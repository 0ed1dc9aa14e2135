"""Single-device exact attention: the numerics baseline of the port.

Counterpart of horovod_tpu/parallel/ring_attention.py, of which this
slice carries only :func:`gqa_group` and :func:`dense_attention` (the
``attention_impl="dense"`` path). Ring attention over a sequence axis
comes with the sequence-parallel slice (ROADMAP.md, Queue 1).
"""

import torch

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
        scale = f32_scale(q.shape[3]).to(q.device)
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
