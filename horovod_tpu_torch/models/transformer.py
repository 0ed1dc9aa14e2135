"""Transformer LM — the flagship model on one device: forward, loss and
gradients.

Counterpart of horovod_tpu/models/transformer.py. The functions keep
the JAX names and parameter layouts — ``wqkv (d, 3, h, hd)``,
``wq (d, h, hd)``, ``wkv (d, 2, h_kv, hd)``, ``wo (h, hd, d)``,
``w1 (d, ff)``, ``w2 (ff, d)``, ``embed (V, d)``, ``lm_head (d, V)``,
``pos (max_seq, d)``, and in a layer of ``cfg.moe_layers`` a nested
``moe`` dict (``w_router (d, E)``, ``w1 (E, d, ff)``, ``w2 (E, ff, d)``)
in place of ``w1``/``w2`` — so a JAX parameter tree converts leaf for
leaf (:func:`params_from_jax`) and a reader finds each counterpart by
name.

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
checkpoint of its own, as the JAX package does. The model draws no
random numbers, so no checkpoint saves the RNG state, which a CUDA graph
capture could not read.

Sequence parallelism is ring attention over ``ShardAxes(sp=RingAxis)``
(parallel/ring_attention.py). On one process with a local ring the
position-wise layers run over the whole local sequence at once and only
attention splits it into shards; over a process group each rank holds
one shard. MoE layers (models/moe.py) run every expert in the process,
or, over ``ShardAxes(ep=group)``, this rank's slice of them
(:func:`slice_expert_params`) with the tokens exchanged by all-to-all.
What the port does not carry raises ``NotImplementedError`` naming the
ROADMAP.md item that adds it: tensor parallelism, data parallelism
inside the model, and Ulysses.
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

from .. import runtime
from ..ops.flash_attention import flash_attention
from ..ops.step_program import StepProgram, engine_cached_program
from ..parallel.ring_attention import (NEG_INF, RingAxis, dense_attention,
                                       gqa_group, ring_attention)
from ..utils.devices import resolve_device
from .moe import (MoEConfig, _einsum_f32, expert_slice, init_moe_params,
                  moe_layer)

TENSOR_PARALLEL = "tensor parallelism (ROADMAP.md, Queue 1 item 6)"
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
    # Layer indices whose FFN is a Mixture-of-Experts block (models/moe.py);
    # empty = all dense.
    moe_layers: tuple = ()
    moe_num_experts: int = 4
    moe_top_k: int = 2

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

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def moe_cfg(self):
        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                         num_experts=self.moe_num_experts,
                         top_k=self.moe_top_k, dtype=self.dtype,
                         param_dtype=self.param_dtype)


@dataclasses.dataclass(frozen=True)
class ShardAxes:
    """The axes the model runs over; None elides each. ``sp`` is a
    :class:`~horovod_tpu_torch.parallel.ring_attention.RingAxis` and
    ``ep`` a process group (the ``ep`` sub-group of the runtime's
    ``expert_mesh()``), where the JAX package names mesh axes. ``dp``
    and ``tp`` are not carried: data parallelism runs in
    ``DistributedOptimizer``, outside the model."""
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
    if axes.ep is not None and not isinstance(axes.ep, dist.ProcessGroup):
        raise TypeError(
            f"axes.ep must be a process group, got {type(axes.ep).__name__}")
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
    """The parameter tree's shapes, in the JAX package's layout (all E
    experts in an MoE layer)."""
    d, h, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    h_kv = cfg.n_kv_heads
    e = cfg.moe_num_experts
    layers = []
    for i in range(cfg.n_layers):
        layer = {"ln1": (d,), "wo": (h, hd, d), "ln2": (d,)}
        if h_kv is not None and h_kv != h:
            layer["wq"] = (d, h, hd)
            layer["wkv"] = (d, 2, h_kv, hd)
        else:
            layer["wqkv"] = (d, 3, h, hd)
        if i in cfg.moe_layers:
            layer["moe"] = {"w_router": (d, e), "w1": (e, d, ff),
                            "w2": (e, ff, d)}
        else:
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
        if name == "moe":
            return init_moe_params(cfg.moe_cfg, generator, device)
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


def slice_expert_params(params, rank, ep):
    """The tree a member of an expert group of ``ep`` ranks holds: every
    MoE layer's ``w1``/``w2`` cut to the ``E / ep`` experts of position
    ``rank`` in the group, every other leaf as it is (the ``ep`` part of
    the JAX package's ``slice_param_shards``; its tensor-parallel part
    comes with ROADMAP.md, Queue 1 item 6)."""
    out = dict(params)
    out["layers"] = [
        {**layer, "moe": expert_slice(layer["moe"], rank, ep)}
        if "moe" in layer else layer for layer in params["layers"]]
    return out


def params_from_jax(tree, cfg, device="cuda"):
    """The port's parameters from a JAX parameter tree whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, params)``): key for key (an
    MoE layer's nested ``moe`` dict too), ``torch.from_numpy`` per leaf,
    no transposes. Raises on a missing or extra key or a shape that does
    not match ``cfg``."""
    device = resolve_device(device)

    def leaf(path, x, shape):
        # Arrays taken from JAX are read-only; torch wants to own a
        # writable buffer.
        t = torch.from_numpy(np.array(x)).to(device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)} for this config")
        return t

    def node(path, got, want):
        if set(got) != set(want):
            raise ValueError(f"{path}: keys {sorted(got)}, expected "
                             f"{sorted(want)} for this config")
        return {k: node(f"{path}[{k}]", got[k], s) if isinstance(s, dict)
                else leaf(f"{path}[{k}]", got[k], s) for k, s in want.items()}

    shapes = param_shapes(cfg)
    if set(tree) != set(shapes):
        raise ValueError(f"params: keys {sorted(tree)}, expected "
                         f"{sorted(shapes)} for this config")
    if len(tree["layers"]) != len(shapes["layers"]):
        raise ValueError(f"{len(tree['layers'])} layers, expected "
                         f"{cfg.n_layers}")
    out = {k: leaf(k, tree[k], s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = [node(f"layers[{i}]", layer, want) for i, (layer, want)
                     in enumerate(zip(tree["layers"], shapes["layers"]))]
    return out


def params_to_numpy(params):
    """The inverse of :func:`params_from_jax`: the parameter tree with
    every leaf a numpy array (a copy on the host), key for key."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x.detach().to("cpu", copy=True).numpy()

    return conv(params)


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


def _mlp_block(p, x, cfg, axes=None, moe_full_capacity=False):
    """Dense or MoE FFN with its residual, by the layer's params; returns
    (output, aux loss), the aux the MoE load-balancing loss (0 for a
    dense layer). Dense: f32 normed rows x w1 (dtype), tanh GELU in f32,
    cast to dtype, x w2 (dtype) with f32 accumulation. MoE: the normed
    rows cast to dtype through :func:`~.moe.moe_layer` over ``axes.ep``;
    ``moe_full_capacity`` is the serving mode, where nothing drops and a
    token's output does not depend on its batch."""
    h = _rmsnorm(x, p["ln2"])
    if "moe" in p:
        ep = None if axes is None else axes.ep
        y, aux = moe_layer(p["moe"], h.to(cfg.dtype), cfg.moe_cfg,
                           ep_group=ep, chunks=_moe_chunks(ep),
                           full_capacity=moe_full_capacity)
        return x + y.to(cfg.dtype), aux
    u = _einsum_f32("bsd,df->bsf", h, p["w1"].to(cfg.dtype))
    u = F.gelu(u, approximate="tanh").to(cfg.dtype)
    out = _einsum_f32("bsf,fd->bsd", u, p["w2"].to(cfg.dtype))
    return x + out.to(cfg.dtype), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


def _moe_chunks(ep_group):
    """The all-to-all chunks of an expert-parallel layer: the session's
    ``HOROVOD_MOE_CHUNKS``, 1 without a session or an expert group."""
    if ep_group is None or not runtime.is_initialized():
        return 1
    return runtime.live_state().config.moe_chunks


def _head(params, x, cfg):
    """Final norm + LM head: (B, S, d) -> f32 logits (B, S, V)."""
    x = _rmsnorm(x, params["ln_f"])
    return _einsum_f32("bsd,dv->bsv", x, params["lm_head"].to(cfg.dtype))


MOE_AUX_COEF = 0.01  # the JAX package's Switch load-balance coefficient


def _one_layer(p, x, cfg, axes):
    x, _, _ = _attention_block_kv(p, x, cfg, axes)
    return _mlp_block(p, x, cfg, axes)


def trunk_with_aux(params, tokens, cfg, axes=None):
    """Pre-head activations (B, S, d) and the total MoE aux loss, summed
    over the MoE layers (0 without any). With ``cfg.remat`` each layer
    runs under a checkpoint, so its activations are recomputed in the
    backward."""
    axes = _check_axes(axes)
    x = embed_tokens(params, tokens, cfg, axes)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["layers"]:
        if cfg.remat:
            x, aux = checkpoint(_one_layer, p, x, cfg, axes,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _one_layer(p, x, cfg, axes)
        aux_total = aux_total + aux
    return x, aux_total


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
                                   targets[:, sl], cfg, use_reentrant=False,
                                   preserve_rng_state=False)
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
    """Mean causal-LM cross entropy over all tokens of the sequence, plus
    ``MOE_AUX_COEF`` times the MoE aux loss. With ``cfg.loss_chunk`` set, the head and the
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
    :func:`init_params` drawn from ``generator``; over ``axes.ep`` the
    caller passes this rank's tree (:func:`slice_expert_params`). An MoE
    layer's leaves are named ``layers.<i>.moe.<leaf>``. Serving runs it
    under ``torch.inference_mode()``, where no graph is kept."""

    def __init__(self, cfg=TransformerConfig(), params=None, *,
                 generator=None, device="cuda", axes=None):
        super().__init__()
        self.cfg = cfg
        self.axes = _check_axes(axes)
        if params is None:
            params = init_params(cfg, generator, device)

        def group(tree):
            return nn.ParameterDict({
                k: group(v) if isinstance(v, dict) else nn.Parameter(v)
                for k, v in tree.items() if k != "layers"})

        self.top = group(params)
        self.layers = nn.ModuleList(group(p) for p in params["layers"])

    @property
    def params(self):
        """The parameter tree the functions of this module take."""
        def tree(pd):
            return {k: tree(v) if isinstance(v, nn.ParameterDict) else v
                    for k, v in pd.items()}

        out = tree(self.top)
        out["layers"] = [tree(p) for p in self.layers]
        return out

    def forward(self, tokens):
        return forward(self.params, tokens, self.cfg, self.axes)

    def loss(self, tokens, targets):
        return loss_fn(self.params, tokens, targets, self.cfg, self.axes)

    def generate(self, prompt, max_new_tokens, max_len=None, **kw):
        return generate(self.params, prompt, self.cfg, max_new_tokens,
                        max_len=max_len, **kw)


# --------------------------------------------------------------- decoding
#
# The cache is updated in place and returned, the counterpart of the JAX
# functions' new cache: its tensors and its position cursor (a 0-dim
# int64 tensor on the cache's device) are what a CUDA graph of
# decode_step reads and writes on every replay.

def init_cache(cfg, batch, max_len, axes=None, device="cuda"):
    """Per-layer K/V cache for incremental decoding: ``{"layers":
    [{"k", "v"}], "pos"}``, each K/V ``(batch, max_len, h_kv, head_dim)``
    in ``cfg.dtype`` and ``pos`` the number of rows written. Under GQA
    it carries n_kv_heads, the decode-time memory the feature saves."""
    _check_axes(axes)
    device = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads or cfg.n_heads, cfg.head_dim)

    def zeros():
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    return {"layers": [{"k": zeros(), "v": zeros()}
                       for _ in range(cfg.n_layers)],
            "pos": torch.zeros((), dtype=torch.int64, device=device)}


def _cache_attention(q, k, v, length, window=None):
    """Single-position attention against the first ``length`` cache rows
    (a 0-dim tensor), or only the last ``window`` of them. q (B, 1, H,
    D); k/v (B, L_max, H_kv, D) with H % H_kv == 0."""
    rep = gqa_group(q.shape[2], k.shape[2], v.shape[2])
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (d ** 0.5)
    idx = torch.arange(s.shape[3], device=q.device)
    mask = idx < length
    if window is not None:
        mask = mask & (idx >= length - window)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _check_fresh_cache(cache):
    """prefill overwrites rows at offset 0 and attends only the prompt;
    on a warm cache that would corrupt earlier entries."""
    pos = int(cache["pos"])
    if pos != 0:
        raise ValueError(
            f"prefill_cache requires a fresh cache (pos == 0), got pos="
            f"{pos}; use decode_step to append to a warm cache")


def prefill_cache(params, cache, tokens, cfg, axes=None):
    """Fill a fresh cache (pos == 0) for a whole prompt in one forward
    pass. Returns (last-position f32 logits (B, vocab), the cache with
    pos advanced by S). Prompt attention runs through the flash kernel
    when ``cfg.attention_impl == "flash"``."""
    _check_axes(axes)
    _check_fresh_cache(cache)
    s_len = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg)
    for p, lc in zip(params["layers"], cache["layers"]):
        x, k, v = _attention_block_kv(p, x, cfg)
        lc["k"][:, :s_len] = k
        lc["v"][:, :s_len] = v
        x, _ = _mlp_block(p, x, cfg)
    logits = _head(params, x[:, -1:], cfg)[:, 0]
    cache["pos"].add_(s_len)
    return logits, cache


def decode_step(params, cache, token, cfg, axes=None):
    """One incremental decode step: ``token`` (B,) int64 at the cache's
    position. Returns (f32 logits (B, vocab), the cache with this
    position's K/V written and pos advanced by one). Runs no host
    synchronization, so a CUDA graph can capture it."""
    _check_axes(axes)
    pos = cache["pos"]
    positions = pos[None]                                          # (1,)
    x = _embed_rows(params, token[:, None])
    if cfg.positional == "learned":
        x = x + params["pos"][positions][None]
    x = x.to(cfg.dtype)
    for p, lc in zip(params["layers"], cache["layers"]):
        h = _rmsnorm(x, p["ln1"])
        q, k_new, v_new = _qkv_proj(p, h, cfg)
        if cfg.positional == "rope":
            q = _rope(q, positions)
            k_new = _rope(k_new, positions)  # the cache keeps rotated K
        lc["k"].index_copy_(1, positions, k_new)
        lc["v"].index_copy_(1, positions, v_new)
        attn = _cache_attention(q, lc["k"], lc["v"], pos + 1,
                                window=cfg.attention_window)
        out = _einsum_f32("bshx,hxd->bsd", attn, p["wo"].to(cfg.dtype))
        x = x + out.to(cfg.dtype)
        x, _ = _mlp_block(p, x, cfg)
    logits = _head(params, x, cfg)[:, 0]
    pos.add_(1)
    return logits, cache


def _select_token(logits, temperature, top_k, generator, dtype):
    """argmax when temperature == 0, else softmax sampling at the given
    temperature over the top_k-filtered logits, drawn from
    ``generator`` (on its own device)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(dtype)
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits >= kth, logits, float("-inf"))
    probs = torch.softmax(logits / temperature, dim=-1)
    draw = torch.multinomial(probs.to(generator.device), 1,
                             generator=generator)
    return draw[:, 0].to(logits.device, dtype)


def tree_leaves(params):
    """The tensors of a parameter tree in the JAX package's leaf order
    (``jax.tree.leaves``: dict keys sorted, layers in order). A ZeRO
    optimizer lays its flat row out in the order of its parameters, so
    ``DistributedOptimizer(AdamW(tree_leaves(lm.params)), zero_stage=k)``
    stripes and chunks the row as the JAX package does."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in tree_leaves(params[k])]
    if isinstance(params, list):
        return [t for v in params for t in tree_leaves(v)]
    return [params]


def _leaves(params):
    """Every tensor of a parameter tree, in tree order."""
    for v in params.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif isinstance(v, list):
            for layer in v:
                yield from _leaves(layer)
        else:
            yield v


def _decoder(params, cfg, batch, max_len, device):
    """``(program, cache)``: ``decode_step`` over a cache of its own and
    one static token (``program.inputs[0]``), returning the logits. On a
    card the program is a CUDA graph, one per (B, max_len), cached in
    the session's program cache when there is a session; its key holds
    the parameters' addresses, which the graph reads."""
    def build():
        cache = init_cache(cfg, batch, max_len, device=device)
        token = torch.zeros((batch,), dtype=torch.int64, device=device)
        pool = None
        if device.type == "cuda" and runtime.is_initialized():
            pool = runtime.live_state().programs.graph_pool()
        prog = StepProgram(lambda: decode_step(params, cache, token, cfg)[0],
                           device, pool, [token])
        return prog, cache

    if not runtime.is_initialized():
        return build()
    sig = ("generate_decode", cfg, batch, max_len, str(device),
           tuple((t.data_ptr(), tuple(t.shape), str(t.dtype))
                 for t in _leaves(params)))
    return engine_cached_program(sig, build)[0]


@torch.inference_mode()
def generate(params, prompt, cfg, max_new_tokens, max_len=None,
             temperature=0.0, top_k=None, generator=None, axes=None):
    """Autoregressive decoding through the KV cache: greedy by default,
    softmax sampling when ``temperature > 0`` (optionally
    top_k-filtered; ``generator``, a ``torch.Generator``, required).
    Returns (B, S + max_new_tokens) int64. The prompt runs through
    :func:`prefill_cache`; on a card every :func:`decode_step` after the
    first replays one CUDA graph per (B, max_len). The sampled draws
    differ from the JAX package's, which come from ``jax.random``."""
    _check_axes(axes)
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key "
                         "(generator=torch.Generator)")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    b, s = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    max_len = max_len or (s + max_new_tokens)
    if max_len < s + max_new_tokens:
        raise ValueError(
            f"max_len ({max_len}) must cover prompt + new tokens "
            f"({s} + {max_new_tokens}); an undersized cache would be "
            f"silently clobbered by the clamped update slice")
    if max_len > cfg.max_seq:
        raise ValueError(
            f"generation length {max_len} exceeds cfg.max_seq "
            f"({cfg.max_seq})")
    prog, cache = _decoder(params, cfg, b, max_len, prompt.device)
    cache["pos"].zero_()
    logits, _ = prefill_cache(params, cache, prompt, cfg)
    token = prog.inputs[0]
    new = [_select_token(logits, temperature, top_k, generator,
                         prompt.dtype)]
    for _ in range(max_new_tokens - 1):
        token.copy_(new[-1])
        new.append(_select_token(prog(), temperature, top_k, generator,
                                 prompt.dtype))
    return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)
