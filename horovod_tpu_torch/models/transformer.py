"""Transformer LM — the flagship model, single device, forward only.

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

What this slice does not carry raises ``NotImplementedError`` naming the
ROADMAP.md item that adds it: sharded axes (tensor, sequence, data
parallel), MoE layers, and training (loss, gradients, remat).
"""

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import dense_attention

TRAINING = "training (ROADMAP.md, Queue 1 item 5)"
TENSOR_PARALLEL = "tensor parallelism (ROADMAP.md, Queue 1 item 6)"
MOE = "MoE layers (ROADMAP.md, Queue 1 item 7)"
SEQUENCE_PARALLEL = "sequence parallelism (ROADMAP.md, Queue 1 item 12)"


def resolve_device(device):
    """``torch.device(device)``, checked: a CUDA device needs a card, and
    on a card f32 matrix products stay exact f32 (TF32 keeps about three
    decimal digits; the JAX package's f32 products keep all of them)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch runs on a CUDA card by default and none "
                "is available; pass device='cpu' to run the plain versions "
                "of its kernels on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


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
    # Only "ring" (the default, unused on one device) is carried.
    sp_impl: str = "ring"
    # "learned" (absolute table) | "rope" (rotary on q/k).
    positional: str = "learned"
    # Sliding-window attention: each query attends the previous
    # `attention_window` positions.
    attention_window: int = None
    # Training options: only their defaults are carried.
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
                f"sp_impl='ulysses' comes with {SEQUENCE_PARALLEL}")
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
        if self.loss_chunk is not None or self.remat:
            raise NotImplementedError(
                f"loss_chunk and remat come with {TRAINING}")

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def _check_axes(axes):
    if axes is not None:
        raise NotImplementedError(
            f"sharded axes come with {TENSOR_PARALLEL} and "
            f"{SEQUENCE_PARALLEL}; this slice runs on one device")


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
    """Embedding lookup plus learned positions starting at 0, cast to
    ``cfg.dtype`` (rope rotates q/k instead)."""
    _check_axes(axes)
    x = _embed_rows(params, tokens)
    if cfg.positional != "learned":
        return x.to(cfg.dtype)
    return (x + params["pos"][:tokens.shape[1]][None]).to(cfg.dtype)


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


def _attention_block_kv(p, x, cfg):
    """Attention sub-block with its residual, also returning the
    post-rope K/V (the serve prefill scatters them into the paged
    pool)."""
    h = _rmsnorm(x, p["ln1"])
    q, k, v = _qkv_proj(p, h, cfg)
    if cfg.positional == "rope":
        positions = torch.arange(x.shape[1], device=x.device)
        q = _rope(q, positions)
        k = _rope(k, positions)
    win = cfg.attention_window
    if cfg.attention_impl == "flash":
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


def forward(params, tokens, cfg, axes=None):
    """f32 logits (B, S, V) of int tokens (B, S)."""
    x = embed_tokens(params, tokens, cfg, axes)
    for p in params["layers"]:
        x, _, _ = _attention_block_kv(p, x, cfg)
        x = _mlp_block(p, x, cfg)
    return _head(params, x, cfg)


def loss_fn(params, tokens, targets, cfg, axes=None):
    raise NotImplementedError(f"the loss comes with {TRAINING}")


class TransformerLM(nn.Module):
    """Holds the parameters (frozen: this slice serves) and runs
    :func:`forward`. ``params`` defaults to :func:`init_params` drawn
    from ``generator``."""

    def __init__(self, cfg=TransformerConfig(), params=None, *,
                 generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, generator, device)

        def frozen(group):
            return nn.ParameterDict({
                k: nn.Parameter(v, requires_grad=False)
                for k, v in group.items() if k != "layers"})

        self.top = frozen(params)
        self.layers = nn.ModuleList(frozen(p) for p in params["layers"])

    @property
    def params(self):
        """The parameter tree the functions of this module take."""
        out = dict(self.top.items())
        out["layers"] = [dict(p.items()) for p in self.layers]
        return out

    def forward(self, tokens):
        return forward(self.params, tokens, self.cfg)

    def loss(self, tokens, targets):
        return loss_fn(self.params, tokens, targets, self.cfg)
