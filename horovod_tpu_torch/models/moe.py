"""Mixture-of-Experts FFN with expert parallelism over a process group.

Counterpart of horovod_tpu/models/moe.py: the Switch capacity-routed
layer, every shape static. Each token picks its top-k experts; a
position-in-expert cumsum assigns capacity slots (slot 0 of every token
before slot 1); tokens past an expert's capacity are dropped (the
residual carries them). The aux output is the Switch load-balancing
loss, ``E * sum_e(frac_routed_e * mean_prob_e)``.

Where the JAX layer builds dense one-hot ``(t, E, C)`` dispatch and
combine tensors and multiplies them in einsums (what the MXU wants), the
port keeps two index tables, built on the device without a host sync
(:func:`_route`):

- slot -> token, ``(E, C)``: an empty slot points at a zero row
  appended to the tokens;
- token -> (expert, slot, gate, kept), ``(t, k)``.

Dispatch is then a gather, which is the einsum's value exactly (a sum
of one row and zeros); combine gathers each token's k expert rows and
sums them, gate-weighted in f32, in slot order. Both backward passes
scatter at most ``top_k`` terms into a row; with k = 2 their order
cannot change the sum, so a graph replay equals an eager step bit for
bit, and the forward has no atomics. At the flagship's training shape
the dense tensors would be 2.7 GB each per layer and their einsums 2.7
TFLOP in f32. :func:`_top_k_dispatch` keeps the dense form as the plain
version (:func:`moe_layer_reference`), which the tests and the card's
smoke run hold the index form to; no model path runs it.

Nothing on the layer's path syncs the host or changes shape with the
data (no ``nonzero``, boolean-mask indexing, ``.item()`` or
``unique``): the capacity is a Python int from static shapes, so a CUDA
graph captures the layer. ``torch.topk`` promises no order among equal
values, so the top-k is a stable descending sort, which breaks ties
toward the lower expert index as ``lax.top_k`` does.

Layout: ``num_experts`` is sharded over the expert group (``ep_group``,
the ``ep`` sub-group of parallel/mesh.py's ``expert_data_mesh``): each
rank holds ``E_loc = E / |ep|`` expert FFNs, routes its own tokens over
all E experts, and exchanges them through the chunked all-to-all
(ops/collectives.py)::

    (t, d) --dispatch--> (E, C, d) --alltoall--> (E_loc, |ep|*C, d)
           --expert FFN--> (E_loc, |ep|*C, d) --alltoall--> (E, C, d)
           --combine--> (t, d)

Numerics follow JAX's promotion as the dense block does: the router in
f32; the expert products ``(E, C, d) dtype x w1.to(dtype)`` summed in
f32, tanh GELU, cast to dtype, ``x w2.to(dtype)`` summed in f32, cast to
dtype (:func:`_einsum_f32`); the combine in f32.

For the phase trace (diag/xla_trace.py) the dispatch and combine
all-to-alls run under ``hvd_dispatch`` and ``hvd_combine`` and the
expert FFN under ``hvd_expert``, as the JAX layer's named scopes. The
ranges enclose the forward's launches: the backward's run on autograd's
thread under the step's ``hvd_backward``.
"""

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.collectives import alltoall, alltoall_chunked
from ..utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 512
    d_ff: int = 2048
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32


def init_moe_params(cfg, generator=None, device="cuda"):
    """``{"w_router" (d, E), "w1" (E, d, ff), "w2" (E, ff, d)}`` in
    ``param_dtype``: normal over sqrt(fan in), as the JAX package draws
    them, from ``generator`` (a CPU ``torch.Generator``)."""
    device = resolve_device(device)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=cfg.param_dtype)
        return (w / math.sqrt(fan_in)).to(device)

    return {"w_router": normal((d, e), d), "w1": normal((e, d, ff), d),
            "w2": normal((e, ff, d), ff)}


def expert_slice(params, rank, ep):
    """The leaves of one expert group member: ``w1`` and ``w2`` cut to
    the ``E / ep`` experts of position ``rank`` in the group (the ``ep``
    part of the JAX package's ``slice_param_shards``); the router is
    whole on every rank."""
    e_loc = params["w1"].shape[0] // ep
    sl = slice(rank * e_loc, (rank + 1) * e_loc)
    return {"w_router": params["w_router"], "w1": params["w1"][sl],
            "w2": params["w2"][sl]}


def _einsum_f32(eq, a, b):
    """``jnp.einsum(eq, a, b, preferred_element_type=jnp.float32)``: the
    operands' values (bf16 is exact in f32) multiplied and summed in
    f32."""
    return torch.einsum(eq, a.float(), b.float())


def capacity(t, cfg, full_capacity=False):
    """Slots per expert for ``t`` tokens: ``ceil(t*k*cf/E)``, or ``t*k``
    (every assignment kept) at full capacity; at least 1."""
    if full_capacity:
        return max(1, t * cfg.top_k)
    return max(1, int(math.ceil(
        t * cfg.top_k * cfg.capacity_factor / cfg.num_experts)))


def _top_k(probs, k):
    """``lax.top_k``: the k largest along the last axis, descending, ties
    toward the lower index (a stable sort; ``torch.topk`` promises no
    order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(x_flat, w_router):
    """Router probabilities (t, E): the f32 product and softmax."""
    logits = x_flat.float() @ w_router.float()
    return torch.softmax(logits, dim=-1)


def _gates_and_positions(probs, top_k):
    """(gates (t, k) renormalised over the k picks, expert index (t, k),
    position in the expert's queue (t, k)): slot 0 of every token takes
    positions before slot 1, which continues from ``base``, as the JAX
    package's cumsum does."""
    e = probs.shape[1]
    gates, idx = _top_k(probs, top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    base = torch.zeros(e, dtype=torch.int64, device=probs.device)
    pos = []
    for slot in range(top_k):
        onehot = F.one_hot(idx[:, slot], e)                      # (t, E)
        queue = torch.cumsum(onehot, dim=0) - 1 + base
        base = base + onehot.sum(0)
        pos.append(torch.gather(queue, 1, idx[:, slot, None])[:, 0])
    return gates, idx, torch.stack(pos, dim=1)


def _top_k_dispatch(probs, top_k, capacity):
    """The plain version: dense ``(t, E, C)`` tensors, the JAX package's
    ``_top_k_dispatch`` op for op.

    probs: (t, E) router probabilities. Returns
      dispatch: (t, E, C) f32 0/1 — token t occupies expert e's slot c,
      combine:  (t, E, C) f32  — dispatch weighted by the (renormalised)
        gate probability."""
    t, e = probs.shape
    gates, idx = _top_k(probs, top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    base = torch.zeros(e, dtype=torch.int64, device=probs.device)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.bool,
                           device=probs.device)
    combine = torch.zeros((t, e, capacity), dtype=torch.float32,
                          device=probs.device)
    for slot in range(top_k):
        onehot = F.one_hot(idx[:, slot], e)                      # (t, E)
        pos = torch.cumsum(onehot, dim=0) - 1 + base[None, :]
        base = base + onehot.sum(0)
        pos_tok = (pos * onehot).sum(1)                          # (t,)
        keep = (pos_tok < capacity) & (onehot.sum(1) > 0)
        slot_hot = (F.one_hot(pos_tok.clamp(0, capacity - 1), capacity)
                    .float() * keep[:, None])                   # (t, C)
        d_slot = onehot[..., None].float() * slot_hot[:, None, :]
        dispatch = dispatch | (d_slot > 0)
        combine = combine + d_slot * gates[:, slot, None, None]
    return dispatch.float(), combine


class Routing(NamedTuple):
    """The index tables of one routing (module docstring)."""
    gates: torch.Tensor       # (t, k) f32, renormalised over the k picks
    expert: torch.Tensor      # (t, k) int64
    position: torch.Tensor    # (t, k) int64, in the expert's queue
    kept: torch.Tensor        # (t, k) bool: position < capacity
    slot: torch.Tensor        # (t, k) int64: expert * C + position, or
    #                           E * C (the zero row) when dropped
    slot_token: torch.Tensor  # (E, C) int64: token of each slot, t if empty


def _route(probs, top_k, capacity):
    """:class:`Routing` of ``probs`` (t, E) at ``capacity`` slots per
    expert, on the device, with no host sync: the kept assignments'
    slots are unique, so one scatter fills the slot table (the dropped
    ones all land on a spare entry that is cut off)."""
    t, e = probs.shape
    gates, idx, pos = _gates_and_positions(probs, top_k)
    kept = pos < capacity
    slot = torch.where(kept, idx * capacity + pos, e * capacity)
    tokens = torch.arange(t, device=probs.device)[:, None].expand(t, top_k)
    slot_token = torch.full((e * capacity + 1,), t, dtype=torch.int64,
                            device=probs.device)
    slot_token.scatter_(0, slot.reshape(-1), tokens.reshape(-1))
    return Routing(gates, idx, pos, kept, slot,
                   slot_token[:-1].view(e, capacity))


def routing_to_dense(r, capacity):
    """The dense ``(dispatch, combine)`` of :func:`_top_k_dispatch` built
    from a :class:`Routing`, for holding the two forms to each other."""
    t, k = r.expert.shape
    e = r.slot_token.shape[0]
    flat = torch.zeros((t, e * capacity + 1), dtype=torch.float32,
                       device=r.gates.device)
    dispatch = flat.scatter(1, r.slot, 1.0)[:, :-1]
    combine = flat.scatter_add(1, r.slot, r.gates * r.kept)[:, :-1]
    return (dispatch.view(t, e, capacity), combine.view(t, e, capacity))


def _aux_loss(probs, expert, kept):
    """The Switch load-balancing loss ``E * sum(frac * mean(probs))``,
    ``frac`` the share of tokens each expert kept (kept assignments per
    token, averaged over the tokens)."""
    t, e = probs.shape
    counts = (F.one_hot(expert, e) * kept[..., None]).sum((0, 1))
    frac = counts.float() / t
    return e * torch.sum(frac * probs.mean(0))


def _ffn(params, z, cfg):
    """The experts' FFN on ``z`` (E_loc, rows, d) in ``cfg.dtype``: the
    phase trace's ``hvd_expert``."""
    with record_function("hvd_expert"):
        h = _einsum_f32("ecd,edf->ecf", z, params["w1"].to(cfg.dtype))
        h = F.gelu(h, approximate="tanh").to(cfg.dtype)
        out = _einsum_f32("ecf,efd->ecd", h, params["w2"].to(cfg.dtype))
        return out.to(cfg.dtype)


def moe_layer(params, x, cfg, ep_group=None, chunks=1, with_stats=False,
              full_capacity=False):
    """Apply the MoE FFN. x: (B, S, d) -> (y, aux_loss).

    ``ep_group=None`` runs every expert here; with a process group,
    ``params["w1"]``/``["w2"]`` hold this rank's ``E / |group|`` experts
    (:func:`expert_slice`) and the tokens travel through the dispatch
    and combine all-to-all. ``chunks > 1`` cuts the exchange into
    capacity slices (``alltoall_chunked``), each dispatched, transformed
    and returned on its own; the result is bit-identical to
    ``chunks=1``. ``full_capacity=True`` is the serving mode: ``t*k``
    slots per expert, so nothing drops and a token's output does not
    depend on its neighbours. ``with_stats=True`` returns ``(y, aux,
    stats)`` with ``routed_tokens`` / ``dropped_tokens`` (this rank's
    kept and lost token-slot assignments, f32 device scalars),
    ``load_balance_loss`` and the ``chunks`` used: the sources of the
    ``hvd_moe_*`` families (metrics.record_moe_step)."""
    b, s, d = x.shape
    t = b * s
    e = cfg.num_experts
    ep = 1 if ep_group is None else torch.distributed.get_world_size(
        ep_group)
    e_loc = params["w1"].shape[0]
    if e_loc * ep != e:
        raise ValueError(
            f"expert shards ({e_loc} x {ep}) != num_experts ({e})")
    x_flat = x.reshape(t, d)
    probs = _router(x_flat, params["w_router"])
    cap = capacity(t, cfg, full_capacity)
    r = _route(probs, cfg.top_k, cap)
    aux = _aux_loss(probs, r.expert, r.kept)

    # Dispatch: one gather; an empty slot reads the appended zero row.
    x_pad = torch.cat([x_flat, x_flat.new_zeros(1, d)])
    expert_in = x_pad[r.slot_token].to(cfg.dtype)                # (E, C, d)
    if ep_group is not None:
        with record_function("hvd_dispatch"):
            pieces = alltoall_chunked(expert_in, chunks, group=ep_group,
                                      split_axis=0, concat_axis=1,
                                      chunk_axis=1)
        outs = []
        for piece in pieces:
            piece = _ffn(params, piece, cfg)
            with record_function("hvd_combine"):
                outs.append(alltoall(piece, group=ep_group, split_axis=1,
                                     concat_axis=0))
        n_chunks = len(outs)
        expert_out = outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)
    else:
        n_chunks = 1
        expert_out = _ffn(params, expert_in, cfg)

    # Combine: each token's k rows, gate-weighted in f32, in slot order;
    # a dropped assignment reads the appended zero row.
    out_pad = torch.cat([expert_out.reshape(e * cap, d).float(),
                         expert_out.new_zeros(1, d, dtype=torch.float32)])
    y = r.gates[:, 0, None] * out_pad[r.slot[:, 0]]
    for slot in range(1, cfg.top_k):
        y = y + r.gates[:, slot, None] * out_pad[r.slot[:, slot]]
    y = y.reshape(b, s, d).to(x.dtype)
    if not with_stats:
        return y, aux
    routed = r.kept.sum().float()
    return y, aux, {"routed_tokens": routed,
                    "dropped_tokens": float(t * cfg.top_k) - routed,
                    "load_balance_loss": aux, "chunks": n_chunks}


def moe_layer_reference(params, x, cfg, with_stats=False,
                        full_capacity=False):
    """The plain version of :func:`moe_layer` (all experts here): the JAX
    layer's dense one-hot dispatch and combine einsums
    (:func:`_top_k_dispatch`), for the tests and the card's smoke run."""
    b, s, d = x.shape
    t = b * s
    e = cfg.num_experts
    x_flat = x.reshape(t, d)
    probs = _router(x_flat, params["w_router"])
    cap = capacity(t, cfg, full_capacity)
    dispatch, combine = _top_k_dispatch(probs, cfg.top_k, cap)
    frac = dispatch.sum(-1).mean(0)
    aux = e * torch.sum(frac * probs.mean(0))
    expert_in = torch.einsum("tec,td->ecd", dispatch,
                             x_flat.float()).to(cfg.dtype)
    expert_out = _ffn(params, expert_in, cfg)
    y = torch.einsum("tec,ecd->td", combine, expert_out.float())
    y = y.reshape(b, s, d).to(x.dtype)
    if not with_stats:
        return y, aux
    routed = dispatch.sum()
    return y, aux, {"routed_tokens": routed,
                    "dropped_tokens": float(t * cfg.top_k) - routed,
                    "load_balance_loss": aux, "chunks": 1}
