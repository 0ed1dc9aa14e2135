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

Sequence parallelism runs over ``ShardAxes(sp=RingAxis)``: ring
attention (parallel/ring_attention.py) or, with ``sp_impl="ulysses"``,
the all-to-all head re-shard (parallel/ulysses.py). On one process with
a local axis the position-wise layers run over the whole local sequence
at once and only attention splits it into shards (the ring by
sequence, Ulysses by heads); over a process group each rank holds one
shard. MoE layers (models/moe.py) run every expert in the process,
or, over ``ShardAxes(ep=group)``, this rank's slice of them with the
tokens exchanged by all-to-all.

Tensor parallelism is Megatron's, over ``ShardAxes(tp=group)`` (the
``model`` sub-group of the runtime's ``model_mesh()``), each rank
holding its shard of the tree (:func:`param_specs`,
:func:`slice_param_shards`): heads (q and kv) split over the group,
``w1`` by columns and ``w2`` by rows, the embedding and the head by
vocabulary stripes. One psum follows ``wo`` and one ``w2``, the
embedding rows are psummed, and the cross entropy runs over the vocab
stripes (a max by all-gather, the normalizer and the target logit by
psum); decoding gathers the logits over the vocabulary. The psum's
backward is a psum (ops/collectives.py ``_psum``), as the reference's
under ``check_vma=False``: a rank's gradient is the reference's
per-shard gradient, and ``DistributedOptimizer(model_keys=...)`` reduces
it as the reference's sharding spec does. TP composes with the ring and
with expert-parallel MoE layers (replicated over the model group).
Data parallelism runs in ``DistributedOptimizer``, outside the model.

Pipeline parallelism runs the layers stacked by stage
(:func:`stack_pipeline_params`, :func:`pipeline_param_specs`) through
the GPipe schedule under autograd (:func:`pipeline_loss_fn`) or the 1F1B
schedule, which computes its own gradients
(:func:`pipeline_value_and_grad_1f1b`), over a pp ``RingAxis``
(parallel/pipeline.py).
"""

import dataclasses
import math
import weakref
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import runtime
from ..ops.collectives import _axis_index, _gather_vocab, _pmax, _psum
from ..ops.flash_attention import flash_attention
from ..ops.step_program import StepProgram, engine_cached_program, obj_token
from ..parallel.ring_attention import (NEG_INF, RingAxis, dense_attention,
                                       gqa_group, ring_attention)
from ..parallel.ulysses import ulysses_attention
from ..utils.devices import resolve_device
from .moe import (MoEConfig, _einsum_f32, expert_slice, init_moe_params,
                  moe_layer)


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
    # Sequence parallelism over ShardAxes.sp: "ring"
    # (parallel/ring_attention.py) | "ulysses" (parallel/ulysses.py).
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
    :class:`~horovod_tpu_torch.parallel.ring_attention.RingAxis`, ``tp``
    and ``ep`` process groups (the ``model`` and ``ep`` sub-groups of
    the runtime's ``model_mesh()`` or ``expert_mesh()``), where the JAX
    package names mesh axes. ``dp`` is not carried: data parallelism
    runs in ``DistributedOptimizer``, outside the model."""
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
    for name in ("tp", "ep"):
        group = getattr(axes, name)
        if group is not None and not isinstance(group, dist.ProcessGroup):
            raise TypeError(f"axes.{name} must be a process group, got "
                            f"{type(group).__name__}")
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


def param_specs(cfg, tp="model", ep="ep"):
    """The sharding of every leaf, as a tree that mirrors the parameter
    tree: each leaf a tuple with one entry a dimension, the axis name
    that dimension is split over or None (the JAX package's
    ``PartitionSpec``, entry for entry; () is replicated). Megatron's
    layout over ``tp``: heads of ``wqkv``/``wq``/``wkv``/``wo``, columns
    of ``w1``, rows of ``w2``, vocabulary stripes of ``embed`` and
    ``lm_head``; an MoE layer's experts over ``ep`` (its router
    replicated). ``tp=None`` or ``ep=None`` leaves that axis out."""
    layers = []
    for i in range(cfg.n_layers):
        layer = {"ln1": (), "wo": (tp, None, None), "ln2": ()}
        if cfg.n_kv_heads is not None and cfg.n_kv_heads != cfg.n_heads:
            layer["wq"] = (None, tp, None)
            layer["wkv"] = (None, None, tp, None)
        else:
            layer["wqkv"] = (None, None, tp, None)
        if i in cfg.moe_layers:
            layer["moe"] = {"w_router": (), "w1": (ep, None, None),
                            "w2": (ep, None, None)}
        else:
            layer["w1"] = (None, tp)
            layer["w2"] = (tp, None)
        layers.append(layer)
    out = {"embed": (tp, None), "layers": layers, "ln_f": (),
           "lm_head": (None, tp)}
    if cfg.positional == "learned":
        out["pos"] = ()
    return out


def _named_leaves(tree, prefix=""):
    """``(dotted name, leaf)`` of a tree in the JAX package's leaf order
    (keys sorted, layers in order): ``layers.3.moe.w1``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def model_parallel_keys(cfg, tp="model"):
    """The full dotted names (``embed``, ``layers.0.wqkv``, ...) of every
    leaf :func:`param_specs` shards over ``tp``: the ``model_keys`` of
    ``DistributedOptimizer``, whose sharding spec matches a parameter by
    substring of its name. Full names, as the JAX package's full tree
    paths: a bare ``wq`` would also match ``wqkv``, and ``w1``/``w2``
    reappear inside MoE layers (``layers.1.moe.w1``), which shard over
    the expert axis, never the model axis. Each name is the
    ``TransformerLM`` parameter's own, less its ``top.`` prefix."""
    if tp is None:
        return ()
    specs = param_specs(cfg, tp=tp, ep=None)
    return tuple(name for name, spec in _named_leaves(specs)
                 if tp in spec)


def _coords(mesh, names):
    """``{axis: (index, size)}`` of this rank on ``mesh`` (a
    ``DeviceMesh``), for the axes of ``names`` it has."""
    out = {}
    for name in names:
        if name in (mesh.mesh_dim_names or ()):
            out[name] = (mesh.get_local_rank(name),
                         mesh.size(mesh.mesh_dim_names.index(name)))
    return out


def slice_param_shards(params, specs, mesh):
    """This rank's shard of a full tree: each leaf cut, along every
    dimension its spec (:func:`param_specs`) splits over an axis of
    ``mesh``, to the block of this rank's position on that axis (the JAX
    package's ``slice_param_shards``, which each device runs for itself
    in a ``shard_map``). ``mesh`` is a ``DeviceMesh``, or a mapping
    ``{axis: (index, size)}``; an axis it lacks, or of size 1, leaves
    the dimension whole. Every leaf is a copy, so training a shard
    leaves the full tree as it was, and the full tree may be dropped."""
    if not isinstance(mesh, dict):
        mesh = _coords(mesh, {a for _, sp in _named_leaves(specs)
                              for a in sp if a is not None})

    def cut(p, spec):
        out = p
        for dim, name in enumerate(spec):
            if name is None or name not in mesh:
                continue
            index, n = mesh[name]
            if n == 1:
                continue
            if p.shape[dim] % n:
                raise ValueError(
                    f"dimension {dim} of size {p.shape[dim]} does not "
                    f"split over {n} ranks of axis {name!r}")
            loc = p.shape[dim] // n
            out = out.narrow(dim, index * loc, loc)
        return out.clone(memory_format=torch.contiguous_format)

    def walk(p, spec):
        if isinstance(p, dict):
            return {k: walk(p[k], spec[k]) for k in p}
        if isinstance(p, list):
            return [walk(a, b) for a, b in zip(p, spec)]
        return cut(p, spec)

    return walk(params, specs)


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
    return _tree_map(lambda x: x.detach().to("cpu", copy=True).numpy(),
                     params)


def _tree_map(fn, tree):
    """``tree`` (dicts, lists of layers) with ``fn`` applied to each
    leaf, key for key."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


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


def _embed_rows(params, tokens, tp=None):
    """Embedding rows (f32, no positions); out-of-range ids give zero
    rows, as the JAX package's masked take does. Over ``tp`` each rank
    holds a contiguous vocabulary stripe: ids outside it give zero rows
    and one psum restores the full row."""
    emb = params["embed"]
    vloc = emb.shape[0]
    local = tokens - _axis_index(tp) * vloc
    valid = (local >= 0) & (local < vloc)
    rows = emb[local.clamp(0, vloc - 1)]
    rows = torch.where(valid[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return _psum(rows, tp)


def embed_tokens(params, tokens, cfg, axes=None):
    """Embedding lookup plus learned positions starting at this process's
    first sequence position, cast to ``cfg.dtype`` (rope rotates q/k
    instead)."""
    axes = _check_axes(axes)
    x = _embed_rows(params, tokens, axes.tp)
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
    if axes.sp is not None and cfg.sp_impl == "ulysses":
        # all-to-all re-shard to (whole sequence, H/n heads); the kernel
        # then runs whole over the global sequence, so a window applies
        # in global positions.
        if cfg.attention_impl == "flash":
            def attn_fn(qg, kg, vg, causal, scale):
                # the kernels apply 1/sqrt(D) themselves
                return flash_attention(qg, kg, vg, causal, window=win)
        else:
            def attn_fn(qg, kg, vg, causal, scale):
                return dense_attention(qg, kg, vg, causal=causal,
                                       scale=scale, window=win)
        attn = ulysses_attention(q, k, v, axes.sp, causal=True,
                                 attn_fn=attn_fn)
    elif axes.sp is not None:
        # ring x flash: the static kernels for each diagonal tile, the band
        # kernels for the visiting tiles under a window; partials merge
        # by log-sum-exp.
        attn = ring_attention(q, k, v, axes.sp, causal=True,
                              impl=cfg.attention_impl, window=win)
    elif cfg.attention_impl == "flash":
        attn = flash_attention(q, k, v, True, window=win)
    else:
        attn = dense_attention(q, k, v, causal=True, window=win)
    # attn (dtype) x wo (dtype) with f32 accumulation, summed over the
    # model group (the row-parallel product), cast to dtype.
    out = _einsum_f32("bshx,hxd->bsd", attn, p["wo"].to(cfg.dtype))
    return x + _psum(out, axes.tp).to(cfg.dtype), k, v


def _mlp_block(p, x, cfg, axes=None, moe_full_capacity=False):
    """Dense or MoE FFN with its residual, by the layer's params; returns
    (output, aux loss), the aux the MoE load-balancing loss (0 for a
    dense layer). Dense: f32 normed rows x w1 (dtype), tanh GELU in f32,
    cast to dtype, x w2 (dtype) with f32 accumulation, summed over
    ``axes.tp`` (column- then row-parallel). MoE: the normed
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
    tp = None if axes is None else axes.tp
    return x + _psum(out, tp).to(cfg.dtype), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _moe_chunks(ep_group):
    """The all-to-all chunks of an expert-parallel layer: the session's
    ``HOROVOD_MOE_CHUNKS``, 1 without a session or an expert group."""
    if ep_group is None or not runtime.is_initialized():
        return 1
    return runtime.live_state().config.moe_chunks


def _head(params, x, cfg):
    """Final norm + LM head: (B, S, d) -> f32 logits (B, S, V), or this
    rank's vocabulary stripe (B, S, V_loc) over a model group."""
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
    """(f32 logits (B, S, V), total MoE aux loss); over ``axes.tp`` the
    logits are this rank's vocabulary stripe (B, S, V_loc)."""
    x, aux = trunk_with_aux(params, tokens, cfg, axes)
    return _head(params, x, cfg), aux


def forward(params, tokens, cfg, axes=None):
    """f32 logits (B, S, V) of int tokens (B, S); (B, S, V_loc) over
    ``axes.tp``."""
    return forward_with_aux(params, tokens, cfg, axes)[0]


def _nll(logits, targets, tp=None):
    """Per-token negative log likelihood (B, S) of f32 logits. The max is
    a stability shift only, so no gradient flows through it (the JAX
    package's ``stop_gradient``); targets outside the vocabulary give a
    zero target logit. Over ``tp`` the logits are vocabulary stripes
    and the full logits never form (Megatron's parallel cross entropy):
    the max by an all-gather, the normalizer and the target logit (from
    the rank whose stripe holds it) by psum."""
    vloc = logits.shape[-1]
    m = _pmax(logits.amax(dim=-1).detach(), tp)
    z = _psum(torch.exp(logits - m[..., None]).sum(dim=-1), tp)
    local = targets - _axis_index(tp) * vloc
    valid = (local >= 0) & (local < vloc)
    tgt = torch.gather(logits, -1,
                       local.clamp(0, vloc - 1)[..., None])[..., 0]
    tgt = torch.where(valid, tgt, torch.zeros((), dtype=tgt.dtype,
                                              device=tgt.device))
    return torch.log(z) + m - _psum(tgt, tp)


def _cross_entropy(logits, targets, tp=None):
    return torch.mean(_nll(logits, targets, tp))


def _chunk_nll_sum(params, xk, tk, cfg, tp):
    return torch.sum(_nll(_head(params, xk, cfg), tk, tp))


def _chunked_cross_entropy(params, x, targets, cfg, tp=None):
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
                                   targets[:, sl], cfg, tp,
                                   use_reentrant=False,
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
    the gradient of the averaged loss.

    Over ``axes.tp`` the ranks of a model group hold the same tokens and
    return the same loss, from the vocabulary stripes of their logits."""
    axes = _check_axes(axes)
    if cfg.loss_chunk:
        x, aux = trunk_with_aux(params, tokens, cfg, axes)
        nll = _chunked_cross_entropy(params, x, targets, cfg, axes.tp)
    else:
        logits, aux = forward_with_aux(params, tokens, cfg, axes)
        nll = _cross_entropy(logits, targets, axes.tp)
    loss = nll + MOE_AUX_COEF * aux
    if axes.sp is not None and axes.sp.distributed:
        loss = _MeanOverRanks.apply(loss, axes.sp.group)
    return loss


# ------------------------------------------------------------ pipeline
#
# The layers stacked by stage (stack_pipeline_params), run through the
# GPipe schedule under autograd (pipeline_loss_fn) or the 1F1B schedule,
# which computes its own gradients (pipeline_value_and_grad_1f1b), over
# a pp RingAxis: local (every stage in this process, the stacked tree
# whole) or one stage a rank of a process group (this rank's block of
# the tree, cut by slice_param_shards with pipeline_param_specs and the
# rank's "pp" coordinate). Weights from the JAX package convert per
# layer (params_from_jax) and stack after.

def _pipeline_is_mixed(cfg):
    """True when the config interleaves dense and MoE layers: the
    per-position stacked layout (a list over in-stage positions)
    replaces the single homogeneous stack."""
    return bool(cfg.moe_layers) and \
        set(cfg.moe_layers) != set(range(cfg.n_layers))


def _pipeline_units(n_layers, interleave, num_stages):
    """(units, layers a position): the one place the divisibility
    contract of the pipelined layouts lives."""
    units = interleave * num_stages
    if n_layers % units != 0:
        raise ValueError(f"n_layers ({n_layers}) not divisible by "
                         f"interleave x num_stages ({units})")
    return units, n_layers // units


def pipeline_param_specs(cfg, tp="model", ep="ep", pp="pp", interleave=1,
                         num_stages=None):
    """:func:`param_specs` for the pipelined layout: ``layers`` carries a
    stacked leading layer dim split over ``pp`` (each stage holds a
    contiguous run of n_layers/S layers); the rest keeps the Megatron
    sharding and is replicated over ``pp``. ``interleave=V`` > 1 gives
    the virtual-chunk layout (V, S, L', ...) with dim 1 split over
    ``pp``: stage s holds virtual stages {c*S + s}. A mixed dense/MoE
    config (``num_stages`` required) gives the per-position layout:
    ``layers`` a list over in-stage positions, each a (V*S, ...) stack of
    that position's layer over the pipeline units."""
    specs = param_specs(cfg, tp=tp, ep=ep)
    lead = (None, pp) if interleave > 1 else (pp,)
    if _pipeline_is_mixed(cfg):
        if num_stages is None:
            raise ValueError(
                "mixed dense/MoE pipeline specs need num_stages")
        _, lpp = _pipeline_units(cfg.n_layers, interleave, num_stages)
        specs["layers"] = [_tree_map(lambda sp: (*lead, *sp),
                                     specs["layers"][j])
                           for j in range(lpp)]
        return specs
    layer = specs["layers"][0]
    if interleave > 1:
        specs["layers"] = _tree_map(lambda sp: (None, pp, None, *sp), layer)
    else:
        specs["layers"] = _tree_map(lambda sp: (pp, *sp), layer)
    return specs


def _structure(tree):
    return tuple(name for name, _ in _named_leaves(tree))


def stack_pipeline_params(params, interleave=1, num_stages=None):
    """The per-layer list stacked into the pipelined layout (leading
    layer dim; :func:`pipeline_param_specs` places it). ``interleave=V``
    with ``num_stages=S`` reshapes to the virtual-chunk layout (V, S, L',
    ...), where layer (c*S + s)*L' + l sits at [c, s, l]. A mixed
    dense/MoE layer list (trees that cannot form one stack) becomes the
    per-position layout: a list over the L' in-stage positions, each
    stacking that position's layer over the V*S pipeline units, shaped
    (S, ...) or (V, S, ...); the kind of each position must repeat in
    every unit. A JAX tree converts per layer (:func:`params_from_jax`)
    and stacks after."""
    from ..parallel.pipeline import stack_layers
    out = dict(params)
    layers = params["layers"]
    n = len(layers)

    def split(a):
        return a.reshape((interleave, num_stages) + tuple(a.shape[1:]))

    if len({_structure(layer) for layer in layers}) > 1:
        if num_stages is None:
            raise ValueError(
                "mixed dense/MoE pipeline layout needs num_stages")
        units, lpp = _pipeline_units(n, interleave, num_stages)
        pos_stacks = []
        for j in range(lpp):
            group = [layers[u * lpp + j] for u in range(units)]
            if len({_structure(g) for g in group}) > 1:
                raise NotImplementedError(
                    f"in-stage position {j} mixes dense and MoE layers "
                    f"across pipeline units; mixed configs need the kind "
                    f"pattern to repeat every {lpp} layers (e.g. "
                    f"alternating dense/MoE aligned to stage boundaries)")
            stk = stack_layers(group)
            pos_stacks.append(_tree_map(split, stk) if interleave > 1
                              else stk)
        out["layers"] = pos_stacks
        return out
    stacked = stack_layers(layers)
    if interleave > 1:
        if num_stages is None or n % (interleave * num_stages) != 0:
            raise ValueError(
                f"interleave={interleave} needs num_stages and n_layers "
                f"({n}) divisible by interleave x num_stages")
        lpc = n // (interleave * num_stages)
        stacked = _tree_map(lambda a: a.reshape(
            (interleave, num_stages, lpc) + tuple(a.shape[1:])), stacked)
    out["layers"] = stacked
    return out


def _apply_stage_layers(stage_layers, h, block):
    """One stage's layers in order: the stacked (L', ...) block layer by
    layer, or the per-position list, each entry (1, ...)."""
    from ..parallel.pipeline import apply_stacked_layers
    if isinstance(stage_layers, list):
        for p in stage_layers:
            h = block(_tree_map(lambda a: a[0], p), h)
        return h
    return apply_stacked_layers(block, stage_layers, h)


def _pipeline_block(cfg, axes):
    """One layer on the pipe's activation (x, aux): the MoE aux loss
    rides through the pipe, so the last stage sees the model's total."""
    def block(p, h):
        x, aux = h
        x, _, _ = _attention_block_kv(p, x, cfg, axes)
        x, a = _mlp_block(p, x, cfg, axes)
        return (x, aux + a)
    return block


def _microbatches(tokens, targets, m):
    b, s = tokens.shape
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    return tokens.reshape(m, b // m, s), targets.reshape(m, b // m, s)


def _pipeline_loss(cfg, axes, targets_mb, moe):
    """The last stage's loss of microbatch ``mb``: the (chunked) cross
    entropy, plus the MoE aux term when the model has MoE layers."""
    def loss(params, h, mb):
        y, aux = h
        if cfg.loss_chunk:
            ce = _chunked_cross_entropy(params, y, targets_mb[mb], cfg,
                                        axes.tp)
        else:
            ce = _cross_entropy(_head(params, y, cfg), targets_mb[mb],
                                axes.tp)
        return ce + MOE_AUX_COEF * aux if moe else ce
    return loss


def _check_pp(pp):
    if not isinstance(pp, RingAxis):
        raise TypeError(f"pp must be a RingAxis, got {type(pp).__name__}")


def pipeline_loss_fn(params, tokens, targets, cfg, axes=None,
                     num_microbatches=4, pp=None):
    """GPipe-pipelined mean cross entropy over the pp axis ``pp`` (a
    :class:`RingAxis`), differentiable by autograd.

    ``params["layers"]`` is the stacked layout (:func:`stack_pipeline_params`):
    all stages' on a local axis, this rank's block over a process group.
    Tokens and targets are (B, S) with B divisible by
    ``num_microbatches``. Composes with the tensor and sequence shardings
    of :func:`loss_fn` (each stage's blocks psum over ``axes.tp`` and
    attend over ``axes.sp``). Over a process group each rank's gradient
    is its own paths': its stage's layers whole, and its share of the
    replicated embedding and head, which sum over the pp group to the
    reference's."""
    from ..parallel.pipeline import _stage_params, last_stage_value, pipeline
    axes = _check_axes(axes)
    moe = _check_pipeline_moe(cfg, num_stages=None if pp is None
                              else pp.size)
    _check_pp(pp)
    m = num_microbatches
    tokens_mb, targets_mb = _microbatches(tokens, targets, m)
    block = _pipeline_block(cfg, axes)

    def stage_fn(s, h):
        layers = _stage_params(params["layers"], s - pp.shards[0],
                               len(pp.shards), 1)
        return _apply_stage_layers(layers, h, block)

    def inject(toks):
        return (embed_tokens(params, toks, cfg, axes),
                torch.zeros((), dtype=torch.float32, device=toks.device))

    loss_f = _pipeline_loss(cfg, axes, targets_mb, moe)
    losses = pipeline(stage_fn, tokens_mb, pp, num_microbatches=m,
                      inject_fn=inject,
                      collect_fn=lambda h, mb: loss_f(params, h, mb))
    loss = last_stage_value(torch.mean(losses), pp)
    if axes.sp is not None and axes.sp.distributed:
        loss = _MeanOverRanks.apply(loss, axes.sp.group)
    return loss


def _check_pipeline_moe(cfg, num_stages=None, interleave=1):
    """MoE x PP composition check. All-MoE models stack homogeneously.
    Mixed dense/MoE composes through the per-position layout when every
    pipeline unit (chunk, stage) sees the same per-position kind
    pattern; a pattern that differs across units would need a program a
    stage. Returns whether MoE is active."""
    if not cfg.moe_layers:
        return False
    if set(cfg.moe_layers) == set(range(cfg.n_layers)):
        return True
    if num_stages is None:
        raise NotImplementedError(
            "mixed dense/MoE pipeline schedules need the stage count to "
            "validate the per-position kind pattern")
    units, lpp = _pipeline_units(cfg.n_layers, interleave, num_stages)
    for j in range(lpp):
        kinds = {(u * lpp + j) in cfg.moe_layers for u in range(units)}
        if len(kinds) > 1:
            raise NotImplementedError(
                f"mixed dense/MoE pipeline stages need a per-position "
                f"kind pattern identical across all {units} pipeline "
                f"units (in-stage position {j} mixes dense and MoE); "
                f"e.g. every-other-layer MoE aligned to stage boundaries "
                f"composes, MoE-only-in-stage-0 does not — use loss_fn "
                f"(pp=1) for such shapes")
    return True


def pipeline_value_and_grad_1f1b(params, tokens, targets, cfg, axes=None,
                                 num_microbatches=4, pp=None, interleave=1,
                                 stage_collectives=None):
    """1F1B-scheduled (loss, grads) over the pp axis ``pp``: the bounded
    activation memory alternative to differentiating
    :func:`pipeline_loss_fn` (parallel/pipeline.py ``pipeline_1f1b``).
    Same layout contract as :func:`pipeline_loss_fn`; do not wrap it in
    autograd. Returns the loss and a gradient tree in ``params``'
    layout: the stacked layers' (this rank's block over a process
    group), and the embedding's and head's summed over the pp group, as
    the reference's. Over ``axes.tp`` (and ``axes.ep`` with MoE layers)
    the loss is replicated on the group's ranks, so the backward's seed
    divides by the group's size and leaves replicated over the group are
    summed over it afterwards; over a distributed ``axes.sp`` the loss
    and the gradients are averaged over the sequence shards.
    ``stage_collectives`` is the reference's (None: whether a tensor,
    sequence or expert axis runs inside the stages); the port's schedule
    is the same either way."""
    from ..parallel.pipeline import pipeline_1f1b
    axes = _check_axes(axes)
    moe = _check_pipeline_moe(cfg, num_stages=None if pp is None
                              else pp.size, interleave=interleave)
    _check_pp(pp)
    if stage_collectives is None:
        stage_collectives = bool(axes.tp or axes.sp or (moe and axes.ep))
    m = num_microbatches
    tokens_mb, targets_mb = _microbatches(tokens, targets, m)
    shared = {k: v for k, v in params.items() if k != "layers"}
    block = _pipeline_block(cfg, axes)

    def stage(stage_layers, h):
        if interleave > 1 and not isinstance(stage_layers, list):
            # one chunk's params arrive (1, L', ...): the stage dim of
            # the (V, S, L', ...) layout
            stage_layers = _tree_map(lambda a: a[0], stage_layers)
        return _apply_stage_layers(stage_layers, h, block)

    def inject(sh, toks):
        return (embed_tokens(sh, toks, cfg, axes),
                torch.zeros((), dtype=torch.float32, device=toks.device))

    # The loss of a (stage, microbatch) is the same on every rank of the
    # tensor group (_nll psums over it) and, with expert parallelism, of
    # the expert group (the all-to-alls hand every rank the same expert
    # outputs). Seeding each rank's vjp with the whole cotangent would
    # differentiate the sum of the copies: the seed divides by the
    # copies, and leaves replicated over those groups sum afterwards.
    rep = [(name, g) for name, g in (("tp", axes.tp),
                                     ("ep", axes.ep if moe else None))
           if g is not None]
    replicas = 1
    for _, g in rep:
        replicas *= dist.get_world_size(g)
    loss, d_layers, d_shared = pipeline_1f1b(
        stage, params["layers"], shared, tokens_mb, pp,
        num_microbatches=m, inject_fn=inject,
        loss_fn=_pipeline_loss(cfg, axes, targets_mb, moe),
        loss_replicas=replicas, num_chunks=interleave,
        stage_collectives=stage_collectives)
    grads = dict(d_shared)
    grads["layers"] = d_layers
    if rep:
        specs = pipeline_param_specs(cfg, tp="tp", ep="ep",
                                     interleave=interleave,
                                     num_stages=pp.size)
        for (_, g), (_, spec) in zip(_named_leaves(grads),
                                     _named_leaves(specs)):
            for name, group in rep:
                if name not in spec:
                    dist.all_reduce(g, group=group)
    if axes.sp is not None and axes.sp.distributed:
        n = dist.get_world_size(axes.sp.group)
        for t in [loss, *_leaves(grads)]:
            dist.all_reduce(t, group=axes.sp.group)
            t.div_(n)
    return loss, grads


class TransformerLM(nn.Module):
    """Holds the parameters (trainable ``nn.Parameter``s) and runs
    :func:`forward` and :func:`loss_fn` on them over ``axes`` (a
    :class:`ShardAxes`; ``ShardAxes(sp=RingAxis.local(4))`` trains with
    sequence parallelism on one card). ``params`` defaults to
    :func:`init_params` drawn from ``generator``; over ``axes.tp`` or
    ``axes.ep`` the caller passes this rank's tree
    (:func:`slice_param_shards`). An MoE
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
        kw.setdefault("axes", self.axes)
        return generate(self.params, prompt, self.cfg, max_new_tokens,
                        max_len=max_len, **kw)


# --------------------------------------------------------------- decoding
#
# The cache is updated in place and returned, the counterpart of the JAX
# functions' new cache: its tensors and its position cursor (a 0-dim
# int64 tensor on the cache's device) are what a CUDA graph of
# decode_step reads and writes on every replay.

def _local_kv_heads(cfg, tp):
    """The kv heads of one rank of the model group ``tp``."""
    h_kv = cfg.n_kv_heads or cfg.n_heads
    if tp is None:
        return h_kv
    n = dist.get_world_size(tp)
    if h_kv % n != 0:
        raise ValueError(
            f"kv head count ({h_kv}) must be divisible by the tp axis "
            f"size ({n})")
    return h_kv // n


def init_cache(cfg, batch, max_len, axes=None, device="cuda"):
    """Per-layer K/V cache for incremental decoding: ``{"layers":
    [{"k", "v"}], "pos"}``, each K/V ``(batch, max_len, h_kv, head_dim)``
    in ``cfg.dtype`` and ``pos`` the number of rows written. Under GQA
    it carries n_kv_heads, the decode-time memory the feature saves;
    over ``axes.tp`` only this rank's kv heads, which the group must
    divide."""
    axes = _check_axes(axes)
    device = resolve_device(device)
    shape = (batch, max_len, _local_kv_heads(cfg, axes.tp), cfg.head_dim)

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
    when ``cfg.attention_impl == "flash"``. Over ``axes.tp`` the prompt
    runs through training's shardings into a head-sharded cache, and
    the logits are gathered over the vocabulary."""
    axes = _check_axes(axes)
    _check_fresh_cache(cache)
    s_len = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg, ShardAxes(tp=axes.tp))
    for p, lc in zip(params["layers"], cache["layers"]):
        x, k, v = _attention_block_kv(p, x, cfg, ShardAxes(tp=axes.tp))
        lc["k"][:, :s_len] = k
        lc["v"][:, :s_len] = v
        x, _ = _mlp_block(p, x, cfg, axes)
    logits = _head(params, x[:, -1:], cfg)[:, 0]
    cache["pos"].add_(s_len)
    return _gather_vocab(logits, axes.tp), cache


def decode_step(params, cache, token, cfg, axes=None):
    """One incremental decode step: ``token`` (B,) int64 at the cache's
    position. Returns (f32 logits (B, vocab), the cache with this
    position's K/V written and pos advanced by one). Runs no host
    synchronization, so a CUDA graph can capture it. Over ``axes.tp``
    it runs training's shardings on a head-sharded cache and gathers
    the logits over the vocabulary."""
    axes = _check_axes(axes)
    tp = axes.tp
    pos = cache["pos"]
    positions = pos[None]                                          # (1,)
    x = _embed_rows(params, token[:, None], tp)
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
        x = x + _psum(out, tp).to(cfg.dtype)
        x, _ = _mlp_block(p, x, cfg, axes)
    logits = _head(params, x, cfg)[:, 0]
    pos.add_(1)
    return _gather_vocab(logits, tp), cache


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
    return [t for _, t in _named_leaves(params)]


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


def _decoder(params, cfg, batch, max_len, device, axes):
    """``(program, cache)``: ``decode_step`` over a cache of its own and
    one static token (``program.inputs[0]``), returning the logits. On a
    card the program is a CUDA graph, one per (B, max_len), cached in
    the session's program cache when there is a session; its key holds
    the parameters' addresses, which the graph reads. The program holds
    the parameters weakly, and the first of them to die drops it from
    the cache."""
    def build():
        cache = init_cache(cfg, batch, max_len, axes, device=device)
        token = torch.zeros((batch,), dtype=torch.int64, device=device)
        pool = None
        if device.type == "cuda" and runtime.is_initialized():
            pool = runtime.live_state().programs.graph_pool()
        refs = _tree_map(weakref.ref, params)
        prog = StepProgram(lambda: decode_step(
            _tree_map(lambda r: r(), refs), cache, token, cfg, axes)[0],
            device, pool, [token])
        return prog, cache

    if not runtime.is_initialized():
        return build()
    sig = ("generate_decode", cfg, batch, max_len, str(device),
           obj_token(axes.tp),
           tuple((t.data_ptr(), tuple(t.shape), str(t.dtype))
                 for t in _leaves(params)))
    (prog, cache), was_hit = engine_cached_program(sig, build)
    if not was_hit:
        programs = runtime.live_state().programs
        for t in _leaves(params):
            weakref.finalize(t, programs.discard, sig)
    return prog, cache


@torch.inference_mode()
def generate(params, prompt, cfg, max_new_tokens, max_len=None,
             temperature=0.0, top_k=None, generator=None, axes=None):
    """Autoregressive decoding through the KV cache: greedy by default,
    softmax sampling when ``temperature > 0`` (optionally
    top_k-filtered; ``generator``, a ``torch.Generator``, required).
    Returns (B, S + max_new_tokens) int64. The prompt runs through
    :func:`prefill_cache`; on a card every :func:`decode_step` after the
    first replays one CUDA graph per (B, max_len). The sampled draws
    differ from the JAX package's, which come from ``jax.random``. Over
    ``axes.tp`` every step runs sharded and every rank selects from the
    same gathered logits (the same ``generator`` seed on every rank
    gives the same draws)."""
    axes = _check_axes(axes)
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
    prog, cache = _decoder(params, cfg, b, max_len, prompt.device, axes)
    cache["pos"].zero_()
    logits, _ = prefill_cache(params, cache, prompt, cfg, axes)
    token = prog.inputs[0]
    new = [_select_token(logits, temperature, top_k, generator,
                         prompt.dtype)]
    for _ in range(max_new_tokens - 1):
        token.copy_(new[-1])
        new.append(_select_token(prog(), temperature, top_k, generator,
                                 prompt.dtype))
    return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)
