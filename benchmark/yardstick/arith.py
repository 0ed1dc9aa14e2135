"""The benchmark's arithmetic: operations and bytes from shapes,
percentiles and interval folds.

Counts follow the MFU convention (the flagship bench's
``flops_per_token``): a training step is 3 times the forward's matrix
products, 2 x M x N x K each; recomputation and capacity padding are not
counted, and an MoE layer counts the ``moe_top_k`` experts a token uses.
Attention adds 6 x L x S x d a token, the causal half of its S^2 work.
"""

import math


def _is_moe(cfg, layer):
    return layer in cfg.get("moe_layers", [])


def product_params(cfg, active=True):
    """Parameters on the matrix-product path: q/k/v, o, the FFN (the
    router and, with ``active``, ``moe_top_k`` experts of an MoE layer,
    else all of them) and the LM head. The embedding (a gather) and the
    norm scales are left out."""
    d, ff = cfg["d_model"], cfg["d_ff"]
    hd = d // cfg["n_heads"]
    attn = d * cfg["n_heads"] * hd * 2 + d * 2 * cfg["n_kv_heads"] * hd
    total = 0
    for layer in range(cfg["n_layers"]):
        total += attn
        if _is_moe(cfg, layer):
            experts = cfg["moe_top_k"] if active else cfg["moe_num_experts"]
            total += d * cfg["moe_num_experts"] + experts * 2 * d * ff
        else:
            total += 2 * d * ff
    return total + d * cfg["vocab_size"]


def flops_per_token(cfg, seq):
    """Training FLOPs a token: 6 x active product parameters plus
    6 x L x S x d for causal attention at sequence length ``seq``."""
    return (6 * product_params(cfg)
            + 6 * cfg["n_layers"] * seq * cfg["d_model"])


def gemm_flops(cfg, tokens):
    """FLOPs of the matrix products of one training step over
    ``tokens`` tokens: each forward product and its two backward
    products, 2 x M x N x K each, experts over their routed tokens."""
    return 6 * product_params(cfg) * tokens


def causal_pairs(seq):
    """(query, key) pairs a causal mask keeps in one (batch, head) row."""
    return seq * (seq + 1) // 2


def attention_work(cfg, batch, seq, item_bytes=2):
    """(FLOPs, bytes) of one training step's attention over all layers:
    2 products forward and 4 backward, 2 x D FLOPs a kept pair each, no
    recompute; bytes count each input read once and each output written
    once, forward (q, k, v in; o and the f32 log-sum-exp out) and
    backward (q, k, v, o, dO and the log-sum-exp in; dq, dk, dv out)."""
    h, h_kv = cfg["n_heads"], cfg["n_kv_heads"]
    d = cfg["d_model"] // h
    flops = 6 * 2 * d * causal_pairs(seq) * batch * h
    q_side = batch * seq * h * d * item_bytes
    kv_side = batch * seq * h_kv * d * item_bytes
    lse = batch * h * seq * 4
    fwd = q_side + 2 * kv_side + q_side + lse
    bwd = 3 * q_side + 2 * kv_side + lse + q_side + 2 * kv_side
    layers = cfg["n_layers"]
    return flops * layers, (fwd + bwd) * layers


def least_time(flops, nbytes, peak_flops, peak_bytes):
    """The least time the card could take: the larger of the two
    bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def percentile(values, q):
    """The ``q``-th percentile by linear interpolation between closest
    ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge(intervals):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(merged):
    return sum(e - s for s, e in merged)


def intersection(a, b):
    """Length of the intersection of two :func:`merge` results."""
    i = j = 0
    got = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            got += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return got


def clip(intervals, start, end):
    """Each interval cut to ``[start, end]``; empty ones dropped."""
    out = []
    for s, e in intervals:
        s, e = max(s, start), min(e, end)
        if e > s:
            out.append((s, e))
    return out
