"""Transformer LM — the flagship model on one device: forward, loss and
gradients.

Counterpart of horovod_tpu/models/transformer.py. The functions keep
the JAX names and parameter layouts — ``wqkv (d, 3, h, hd)``,
``wq (d, h, hd)``, ``wkv (d, 2, h_kv, hd)``, ``wo (h, hd, d)``,
``w1 (d, ff)``, ``w2 (ff, d)``, ``embed (V, d)``, ``lm_head (d, V)``,
``pos (max_seq, d)`` — so a JAX parameter tree converts leaf for leaf
(:func:`params_from_jax`) and a reader finds each counterpart by name.

Numerics follow JAX's type promotion, op for op:

- parameters are stored in ``param_dtype`` (f32) and cast to ``dtype``
  per op, as ``p.astype(cfg.dtype)`` does;
- ``_rmsnorm`` returns f32, because its scale is an f32 parameter, so
  the q/k/v projection, ``w1`` and the LM head are f32 products with
  weights rounded to ``dtype``;
- ``u @ w2`` and ``attn @ wo`` are ``dtype`` x ``dtype`` products with
  f32 accumulation, cast back to ``dtype``;
- every product runs in exact f32 (``_einsum_f32``; TF32 is off), as
  ``preferred_element_type=jnp.float32`` does;
- GELU is the tanh approximation, ``jax.nn.gelu``'s default.

Gradients come from autograd through the same ops, so they take the
JAX transposes' roundings too: the transpose of ``p.astype(bf16)`` rounds
each weight's f32 gradient to bf16, and the ``.to(dtype)`` /
``.float()`` pair around every product does the same here. Do not drop
a cast as redundant. ``remat`` checkpoints each layer
(``torch.utils.checkpoint``, as ``jax.checkpoint``), and ``loss_chunk``
runs the head and the cross entropy per sequence chunk under a
checkpoint of its own, as the JAX package does.

Sequence parallelism is ring attention over ``ShardAxes(sp=RingAxis)``
(parallel/ring_attention.py). On one process with a local ring the
position-wise layers run over the whole local sequence at once and only
attention splits it into shards; over a process group each rank holds
one shard. What this slice does not carry raises ``NotImplementedError``
naming the ROADMAP.md item that adds it: tensor and expert parallelism,
data parallelism inside the model, Ulysses, and MoE layers.
"""

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import RingAxis, dense_attention, ring_attention
from ..utils.devices import resolve_device

TENSOR_PARALLEL = "tensor parallelism (ROADMAP.md, Queue 1 item 6)"
MOE = "MoE layers (ROADMAP.md, Queue 1 item 7)"
ULYSSES = "Ulysses sequence parallelism (ROADMAP.md, Queue 1 item 12)"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 2048
    # Grouped-query attention: K/V head count (None = n_heads, plain MHA).
    n_kv_heads: int = None
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # "dense" (ring_attention.dense_attention) | "flash" (the Hopper
    # kernel, ops/flash_attention.py).
    attention_impl: str = "dense"
    # Sequence parallelism over ShardAxes.sp: only "ring" is carried.
    sp_impl: str = "ring"
    # "learned" (absolute table) | "rope" (rotary on q/k).
    positional: str = "learned"
    # Sliding-window attention: each query attends the previous
    # `attention_window` positions.
    attention_window: int = None
    # Head + cross entropy per sequence chunk of this many positions
    # (None: the whole sequence at once), each chunk under a checkpoint.
    # remat: each layer under a checkpoint (recomputed in the backward).
    loss_chunk: int = None
    remat: bool = False
    moe_layers: tuple = ()

    def __post_init__(self):
        if self.attention_impl not in ("dense", "flash"):
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}; "
                "expected 'dense' or 'flash'")
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"unknown sp_impl {self.sp_impl!r}; "
                "expected 'ring' or 'ulysses'")
        if self.sp_impl == "ulysses":
            raise NotImplementedError(
                f"sp_impl='ulysses' comes with {ULYSSES}")
        if self.n_kv_heads is not None \
                and self.n_heads % self.n_kv_heads != 0:
            raise ValueError(
                f"n_heads ({self.n_heads}) must be divisible by "
                f"n_kv_heads ({self.n_kv_heads})")
        if self.attention_window is not None and self.attention_window < 1:
            raise ValueError(
                f"attention_window must be >= 1, got "
                f"{self.attention_window}")
        if self.positional not in ("learned", "rope"):
            raise ValueError(
                f"unknown positional {self.positional!r}; expected "
                "'learned' or 'rope'")
        if self.positional == "rope" and self.head_dim % 2 != 0:
            raise ValueError(
                f"rope needs an even head_dim, got {self.head_dim}")
        if self.moe_layers:
            raise NotImplementedError(f"moe_layers come with {MOE}")

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class ShardAxes:
    """The axes the model runs over; None elides each. ``sp`` is a
    :class:`~horovod_tpu_torch.parallel.ring_attention.RingAxis`, where
    the JAX package names a mesh axis. ``dp``, ``tp`` and ``ep`` are not
    carried: data parallelism runs in ``DistributedOptimizer``, outside
    the model."""
    dp: Any = None
    sp: Any = None
    tp: Any = None
    ep: Any = None


def _check_axes(axes):
    """``axes`` or the unsharded default, checked."""
    if axes is None:
        return ShardAxes()
    if not isinstance(axes, ShardAxes):
        raise TypeError(f"axes must be a ShardAxes, got {type(axes).__name__}")
    if axes.tp is not None:
        raise NotImplementedError(f"axes.tp comes with {TENSOR_PARALLEL}")
    if axes.ep is not None:
        raise NotImplementedError(f"axes.ep comes with {MOE}")
    if axes.dp is not None:
        raise NotImplementedError(
            "axes.dp: the port averages over data-parallel ranks in "
            "DistributedOptimizer; pass dp=None")
    if axes.sp is not None and not isinstance(axes.sp, RingAxis):
        raise TypeError(
            f"axes.sp must be a RingAxis, got {type(axes.sp).__name__}")
    return axes


def _sp_start(axes, s):
    """Global position of the first of ``s`` local positions: this
    process's first shard times the shard length."""
    if axes.sp is None:
        return 0
    return axes.sp.shards[0] * (s // len(axes.sp.shards))


def param_shapes(cfg):
    """The parameter tree's shapes, in the JAX package's layout."""
    d, h, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    h_kv = cfg.n_kv_heads
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"ln1": (d,), "wo": (h, hd, d), "ln2": (d,)}
        if h_kv is not None and h_kv != h:
            layer["wq"] = (d, h, hd)
            layer["wkv"] = (d, 2, h_kv, hd)
        else:
            layer["wqkv"] = (d, 3, h, hd)
        layer["w1"] = (d, ff)
        layer["w2"] = (ff, d)
        layers.append(layer)
    out = {"embed": (cfg.vocab_size, d), "layers": layers, "ln_f": (d,),
           "lm_head": (d, cfg.vocab_size)}
    if cfg.positional == "learned":
        out["pos"] = (cfg.max_seq, d)
    return out


def init_params(cfg, generator=None, device="cuda"):
    """Random parameters in ``param_dtype``: norm scales at 1, every
    matrix normal over sqrt(fan in), as the JAX package initializes
    them. Draws come from ``generator`` (a CPU ``torch.Generator``, so a
    seed gives the same weights on any device), not from JAX's keys."""
    device = resolve_device(device)
    pd = cfg.param_dtype

    def make(name, shape):
        if name.startswith("ln"):
            return torch.ones(shape, dtype=pd, device=device)
        fan_in = cfg.d_ff if name == "w2" else cfg.d_model
        w = torch.randn(shape, generator=generator, dtype=pd)
        return (w / math.sqrt(fan_in)).to(device)

    shapes = param_shapes(cfg)
    out = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = [{k: make(k, s) for k, s in layer.items()}
                     for layer in shapes["layers"]]
    return out


def params_from_jax(tree, cfg, device="cuda"):
    """The port's parameters from a JAX parameter tree whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, params)``): key for key,
    ``torch.from_numpy`` per leaf, no transposes. Raises on a missing or
    extra key or a shape that does not match ``cfg``."""
    device = resolve_device(device)

    def leaf(path, x, shape):
        # Arrays taken from JAX are read-only; torch wants to own a
        # writable buffer.
        t = torch.from_numpy(np.array(x)).to(device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)} for this config")
        return t

    def keys_match(path, got, want):
        if set(got) != set(want):
            raise ValueError(f"{path}: keys {sorted(got)}, expected "
                             f"{sorted(want)} for this config")

    shapes = param_shapes(cfg)
    keys_match("params", tree, shapes)
    if len(tree["layers"]) != len(shapes["layers"]):
        raise ValueError(f"{len(tree['layers'])} layers, expected "
                         f"{cfg.n_layers}")
    out = {k: leaf(k, tree[k], s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = []
    for i, (layer, want) in enumerate(zip(tree["layers"], shapes["layers"])):
        keys_match(f"layers[{i}]", layer, want)
        out["layers"].append({k: leaf(f"layers[{i}][{k}]", layer[k], s)
                              for k, s in want.items()})
    return out


def params_to_numpy(params):
    """The inverse of :func:`params_from_jax`: the parameter tree with
    every leaf a numpy array (a copy on the host), key for key."""
    def leaf(t):
        return t.detach().to("cpu", copy=True).numpy()

    out = {k: leaf(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: leaf(v) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def _einsum_f32(eq, a, b):
    """``jnp.einsum(eq, a, b, preferred_element_type=jnp.float32)``: the
    operands' values (bf16 is exact in f32) multiplied and summed in
    f32."""
    return torch.einsum(eq, a.float(), b.float())


def _rope_angles(positions, half, theta):
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    return positions[..., None].to(torch.float32) * freqs


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    # x (dtype) times the f32 angles promotes to f32 before the cast back.
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope(x, positions, theta=10000.0):
    """Rotary embedding of x (B, S, H, D) at positions (S,), half-split
    layout ``[x1 cos - x2 sin, x1 sin + x2 cos]``."""
    ang = _rope_angles(positions, x.shape[-1] // 2, theta)  # (S, half)
    return _rotate(x, torch.cos(ang)[None, :, None, :],
                   torch.sin(ang)[None, :, None, :])


def _rope_b(x, positions, theta=10000.0):
    """:func:`_rope` with per-sequence positions (B, S) — the decode
    variant, where each sequence sits at its own offset."""
    ang = _rope_angles(positions, x.shape[-1] // 2, theta)  # (B, S, half)
    return _rotate(x, torch.cos(ang)[:, :, None, :],
                   torch.sin(ang)[:, :, None, :])


def _rmsnorm(x, scale):
    """RMS norm with eps 1e-6. The normalized row is cast back to x's
    dtype and then multiplied by the f32 scale, so the result is f32 —
    JAX's promotion, which the products after it inherit."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _embed_rows(params, tokens):
    """Embedding rows (f32, no positions); out-of-range ids give zero
    rows, as the JAX package's masked take does."""
    emb = params["embed"]
    vocab = emb.shape[0]
    valid = (tokens >= 0) & (tokens < vocab)
    rows = emb[tokens.clamp(0, vocab - 1)]
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))


def embed_tokens(params, tokens, cfg, axes=None):
    """Embedding lookup plus learned positions starting at this process's
    first sequence position, cast to ``cfg.dtype`` (rope rotates q/k
    instead)."""
    axes = _check_axes(axes)
    x = _embed_rows(params, tokens)
    if cfg.positional != "learned":
        return x.to(cfg.dtype)
    start = _sp_start(axes, tokens.shape[1])
    pos = params["pos"][start:start + tokens.shape[1]]
    return (x + pos[None]).to(cfg.dtype)


def _qkv_proj(p, h, cfg):
    """q/k/v projection of the f32 normed rows against weights rounded to
    ``cfg.dtype`` (``jnp.einsum(h, w.astype(dtype))`` promotes to f32),
    each cast to ``cfg.dtype``."""
    if "wq" in p:
        q = _einsum_f32("bsd,dhx->bshx", h, p["wq"].to(cfg.dtype))
        kv = _einsum_f32("bsd,dchx->bschx", h, p["wkv"].to(cfg.dtype))
        kv = kv.to(cfg.dtype)
        return q.to(cfg.dtype), kv[:, :, 0], kv[:, :, 1]
    qkv = _einsum_f32("bsd,dchx->bschx", h, p["wqkv"].to(cfg.dtype))
    qkv = qkv.to(cfg.dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attention_block_kv(p, x, cfg, axes=None):
    """Attention sub-block with its residual, also returning the
    post-rope K/V (the serve prefill scatters them into the paged
    pool). Over ``axes.sp`` attention is ring attention, and rope
    positions start at this process's first sequence position."""
    axes = _check_axes(axes)
    h = _rmsnorm(x, p["ln1"])
    q, k, v = _qkv_proj(p, h, cfg)
    if cfg.positional == "rope":
        start = _sp_start(axes, x.shape[1])
        positions = start + torch.arange(x.shape[1], device=x.device)
        q = _rope(q, positions)
        k = _rope(k, positions)
    win = cfg.attention_window
    if axes.sp is not None:
        # ring x flash: the static kernels for each diagonal tile, the band
        # kernels for the visiting tiles under a window; partials merge
        # by log-sum-exp.
        attn = ring_attention(q, k, v, axes.sp, causal=True,
                              impl=cfg.attention_impl, window=win)
    elif cfg.attention_impl == "flash":
        attn = flash_attention(q, k, v, True, window=win)
    else:
        attn = dense_attention(q, k, v, causal=True, window=win)
    # attn (dtype) x wo (dtype) with f32 accumulation, cast to dtype.
    out = _einsum_f32("bshx,hxd->bsd", attn, p["wo"].to(cfg.dtype))
    return x + out.to(cfg.dtype), k, v


def _mlp_block(p, x, cfg):
    """Dense FFN with its residual: f32 normed rows x w1 (dtype), tanh
    GELU in f32, cast to dtype, x w2 (dtype) with f32 accumulation."""
    h = _rmsnorm(x, p["ln2"])
    u = _einsum_f32("bsd,df->bsf", h, p["w1"].to(cfg.dtype))
    u = F.gelu(u, approximate="tanh").to(cfg.dtype)
    out = _einsum_f32("bsf,fd->bsd", u, p["w2"].to(cfg.dtype))
    return x + out.to(cfg.dtype)


def _head(params, x, cfg):
    """Final norm + LM head: (B, S, d) -> f32 logits (B, S, V)."""
    x = _rmsnorm(x, params["ln_f"])
    return _einsum_f32("bsd,dv->bsv", x, params["lm_head"].to(cfg.dtype))


MOE_AUX_COEF = 0.01  # the JAX package's Switch load-balance coefficient


def _one_layer(p, x, cfg, axes):
    x, _, _ = _attention_block_kv(p, x, cfg, axes)
    return _mlp_block(p, x, cfg)


def trunk_with_aux(params, tokens, cfg, axes=None):
    """Pre-head activations (B, S, d) and the total MoE aux loss (0: no
    MoE layers in this slice). With ``cfg.remat`` each layer runs under
    a checkpoint, so its activations are recomputed in the backward."""
    axes = _check_axes(axes)
    x = embed_tokens(params, tokens, cfg, axes)
    for p in params["layers"]:
        if cfg.remat:
            x = checkpoint(_one_layer, p, x, cfg, axes, use_reentrant=False)
        else:
            x = _one_layer(p, x, cfg, axes)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_with_aux(params, tokens, cfg, axes=None):
    """(f32 logits (B, S, V), total MoE aux loss)."""
    x, aux = trunk_with_aux(params, tokens, cfg, axes)
    return _head(params, x, cfg), aux


def forward(params, tokens, cfg, axes=None):
    """f32 logits (B, S, V) of int tokens (B, S)."""
    return forward_with_aux(params, tokens, cfg, axes)[0]


def _nll(logits, targets):
    """Per-token negative log likelihood (B, S) of f32 logits. The max is
    a stability shift only, so no gradient flows through it (the JAX
    package's ``stop_gradient``); targets outside the vocabulary give a
    zero target logit."""
    vocab = logits.shape[-1]
    m = logits.amax(dim=-1).detach()
    z = torch.exp(logits - m[..., None]).sum(dim=-1)
    valid = (targets >= 0) & (targets < vocab)
    tgt = torch.gather(logits, -1,
                       targets.clamp(0, vocab - 1)[..., None])[..., 0]
    tgt = torch.where(valid, tgt, torch.zeros((), dtype=tgt.dtype,
                                              device=tgt.device))
    return torch.log(z) + m - tgt


def _cross_entropy(logits, targets):
    return torch.mean(_nll(logits, targets))


def _chunk_nll_sum(params, xk, tk, cfg):
    return torch.sum(_nll(_head(params, xk, cfg), tk))


def _chunked_cross_entropy(params, x, targets, cfg):
    """Mean cross entropy with the head applied per sequence chunk under
    a checkpoint: the logits of one (B, chunk, V) chunk exist at a time
    in both directions. Chunk sums accumulate into an f32 carry, divided
    by B*S once at the end, as the JAX package's scan does."""
    chunk = cfg.loss_chunk
    b, s, _ = x.shape
    if s % chunk != 0:
        raise ValueError(
            f"loss_chunk ({chunk}) must divide the per-shard sequence "
            f"length ({s}); pick a divisor (e.g. {math.gcd(s, chunk)})")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_chunk_nll_sum, params, x[:, sl],
                                   targets[:, sl], cfg, use_reentrant=False)
    return total / (b * s)


class _MeanOverRanks(torch.autograd.Function):
    """The value averaged over ``group``; the gradient passes through."""

    @staticmethod
    def forward(ctx, loss, group):
        out = loss.detach().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def loss_fn(params, tokens, targets, cfg, axes=None):
    """Mean causal-LM cross entropy over all tokens of the sequence (+ the
    MoE aux term, 0 here). With ``cfg.loss_chunk`` set, the head and the
    cross entropy run per sequence chunk and full logits never
    materialize.

    Over ``axes.sp``: a local ring holds the whole sequence, so the mean
    is taken here. Over a process group each rank's loss is its shard's
    mean, and the value returned is that mean averaged over the ranks
    (the JAX package's ``pmean`` over ``sp``), while the gradient flowing
    back is the shard's own. The ring's backward sends each rank the
    dK/dV of the other ranks' queries, so the world average of the
    ranks' gradients, which ``DistributedOptimizer`` already takes, is
    the gradient of the averaged loss."""
    axes = _check_axes(axes)
    if cfg.loss_chunk:
        x, aux = trunk_with_aux(params, tokens, cfg, axes)
        nll = _chunked_cross_entropy(params, x, targets, cfg)
    else:
        logits, aux = forward_with_aux(params, tokens, cfg, axes)
        nll = _cross_entropy(logits, targets)
    loss = nll + MOE_AUX_COEF * aux
    if axes.sp is not None and axes.sp.distributed:
        loss = _MeanOverRanks.apply(loss, axes.sp.group)
    return loss


class TransformerLM(nn.Module):
    """Holds the parameters (trainable ``nn.Parameter``s) and runs
    :func:`forward` and :func:`loss_fn` on them over ``axes`` (a
    :class:`ShardAxes`; ``ShardAxes(sp=RingAxis.local(4))`` trains with
    sequence parallelism on one card). ``params`` defaults to
    :func:`init_params` drawn from ``generator``. Serving runs it under
    ``torch.inference_mode()``, where no graph is kept."""

    def __init__(self, cfg=TransformerConfig(), params=None, *,
                 generator=None, device="cuda", axes=None):
        super().__init__()
        self.cfg = cfg
        self.axes = _check_axes(axes)
        if params is None:
            params = init_params(cfg, generator, device)

        def group(tree):
            return nn.ParameterDict({k: nn.Parameter(v)
                                     for k, v in tree.items()
                                     if k != "layers"})

        self.top = group(params)
        self.layers = nn.ModuleList(group(p) for p in params["layers"])

    @property
    def params(self):
        """The parameter tree the functions of this module take."""
        out = dict(self.top.items())
        out["layers"] = [dict(p.items()) for p in self.layers]
        return out

    def forward(self, tokens):
        return forward(self.params, tokens, self.cfg, self.axes)

    def loss(self, tokens, targets):
        return loss_fn(self.params, tokens, targets, self.cfg, self.axes)
