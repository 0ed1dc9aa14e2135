"""What each gloo rank runs in tests/test_torch_collectives.py and the
expert-parallel cases of tests/test_torch_moe.py (through
tests/torch_ranks.py's ``spawn_ranks``). No JAX here: every rank
imports this module. Each function returns numpy arrays and plain
values, which the test compares with the JAX package in its own
process."""

import json

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import moe
from horovod_tpu_torch.ops.collectives import alltoall, alltoall_chunked


def collectives(inp, pairs):
    """alltoall over the world for each (split, concat) pair, its
    backward, and alltoall_chunked against unchunked; the expert mesh's
    layout (HOROVOD_EXPERT_PARALLEL is set by the caller)."""
    hvd.init(device="cpu")
    r = hvd.rank()
    out = {"rank": r, "size": hvd.size()}
    x = torch.from_numpy(inp["x"][r])
    g = torch.from_numpy(inp["g"][r])
    for split, concat in pairs:
        xg = x.clone().requires_grad_()
        y = alltoall(xg, split_axis=split, concat_axis=concat)
        (y * alltoall(g, split_axis=split, concat_axis=concat)).sum() \
            .backward()
        out[f"y{split}{concat}"] = y.detach().numpy()
        out[f"grad{split}{concat}"] = xg.grad.numpy()
    whole = alltoall(x, split_axis=0, concat_axis=2)
    for chunks in (1, 2, 3, 4):
        pieces = alltoall_chunked(x, chunks, split_axis=0, concat_axis=2,
                                  chunk_axis=1)
        out[f"chunks{chunks}"] = len(pieces)
        out[f"chunked{chunks}_equal"] = torch.equal(torch.cat(pieces, 1),
                                                    whole)
    stats = hvd.runtime.live_state().stats
    out["alltoall_jit_calls"] = stats.counter("alltoall_jit")
    out.update(reduce_scatter_family(inp, r))
    mesh = hvd.expert_mesh()
    out["ep_size"] = hvd.expert_parallel_size()
    out["coordinate"] = mesh.get_coordinate()
    out["ep_group"] = dist.get_process_group_ranks(mesh.get_group("ep"))
    out["data_group"] = dist.get_process_group_ranks(mesh.get_group("hvd"))
    hvd.shutdown()
    return out


def reduce_scatter_family(inp, r):
    """``reducescatter``, ``bucketed_reducescatter_allgather`` and
    ``hierarchical_allreduce`` on a 2 x 2 ``hierarchical_mesh``, on this
    rank's inputs."""
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.parallel.mesh import (hierarchical_axes,
                                                 hierarchical_mesh)
    out = {}
    rs = torch.from_numpy(inp["rs"][r])
    out["rs_sum"] = C.reducescatter(rs).numpy()
    out["rs_avg"] = C.reducescatter(rs, average=True).numpy()
    stats = hvd.runtime.live_state().stats
    rs0, ag0 = stats.counter("reducescatter_jit"), \
        stats.counter("allgather_jit")
    leaves = [torch.from_numpy(inp[k][r]) for k in ("bk_a", "bk_b", "bk_c")]
    got = C.bucketed_reducescatter_allgather(leaves, bucket_bytes=32)
    out["bk"] = [t.numpy() for t in got]
    out["bk_records"] = (stats.counter("reducescatter_jit") - rs0,
                         stats.counter("allgather_jit") - ag0)
    mesh = hierarchical_mesh("cpu", hvd.size(), 2)
    out["hier_coordinate"] = mesh.get_coordinate()
    ici, dcn = hierarchical_axes(mesh)
    for k in ("h_odd", "h_2d"):
        x = torch.from_numpy(inp[k][r])
        out[f"{k}_avg"] = C.hierarchical_allreduce(x, ici, dcn,
                                                   mesh=mesh).numpy()
        out[f"{k}_sum"] = C.hierarchical_allreduce(
            x, ici, dcn, average=False, mesh=mesh).numpy()
    hi = torch.from_numpy(inp["h_int"][r])
    out["h_int_sum"] = C.hierarchical_allreduce(hi, ici, dcn, average=False,
                                                mesh=mesh).numpy()
    return out


class _MoELoss(torch.nn.Module):
    """One MoE layer and the JAX bench's loss, mean((y - target)^2) +
    0.01 aux, over the expert group ``group``."""

    def __init__(self, params, cfg, group, chunks):
        super().__init__()
        self.moe = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v.clone()) for k, v in params.items()})
        self.cfg, self.group, self.chunks = cfg, group, chunks

    def loss(self, x, target):
        y, aux = moe.moe_layer(dict(self.moe.items()), x, self.cfg,
                               ep_group=self.group, chunks=self.chunks)
        return ((y - target) ** 2).mean() + 0.01 * aux


def expert_parallel(inp, cfg_kw, steps, lr):
    """The layer over the expert group (chunks 1, 3 and 4) and locally
    with every expert, then ``steps`` SGD steps under
    ``DistributedOptimizer(expert_keys=("w1", "w2"))``, eagerly and
    through ``compiled_train_step`` from the same start."""
    hvd.init(device="cpu")
    r = hvd.rank()
    ep = hvd.expert_parallel_size()
    group = hvd.expert_mesh().get_group("ep")
    cfg = moe.MoEConfig(dtype=torch.float32, **cfg_kw)
    full = {k: torch.from_numpy(inp[k]) for k in ("w_router", "w1", "w2")}
    mine = moe.expert_slice(full, r % ep, ep)
    x = torch.from_numpy(inp["x"][r])
    out = {"rank": r}
    with torch.no_grad():
        out["y_local"] = moe.moe_layer(full, x, cfg)[0].numpy()
        for chunks in (1, 3, 4):
            y, aux, st = moe.moe_layer(mine, x, cfg, ep_group=group,
                                       chunks=chunks, with_stats=True)
            out[f"y_ep{chunks}"] = y.numpy()
            out[f"chunks_used{chunks}"] = st["chunks"]
    target = torch.from_numpy(inp["target"][r])
    for mode in ("eager", "compiled"):
        model = _MoELoss(mine, cfg, group, chunks=2)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=lr),
            named_parameters=model.named_parameters(),
            expert_keys=("w1", "w2"))
        step = hvd.compiled_train_step(model.loss, opt) \
            if mode == "compiled" else None
        for i in range(steps):
            if step is None:
                opt.zero_grad(set_to_none=True)
                model.loss(x, target).backward()
                opt.step()
            else:
                step(x, target)
            for k, v in model.moe.items():
                out[f"{mode}{i}:{k}"] = v.detach().numpy().copy()
        if step is not None:
            out["exchange_mode"] = step._exchange
    hvd.shutdown()
    return out


# ---------------------------------------------------------------- ZeRO

class _MLP(torch.nn.Module):
    """tests/test_zero_sharding.py's 6 -> 13 -> 3 MLP. Its parameters
    register in the JAX package's leaf order (sorted keys: b1, b2, w1,
    w2), so the ZeRO flat row matches the reference's element for
    element."""

    def __init__(self, params):
        super().__init__()
        for k in ("b1", "b2", "w1", "w2"):
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(np.array(params[k]))))

    def loss(self, x, y):
        h = torch.tanh(x @ self.w1 + self.b1)
        return ((h @ self.w2 + self.b2 - y) ** 2).mean()

    def numpy(self):
        return {k: v.detach().numpy().copy()
                for k, v in self.named_parameters()}


def _zero_train(inp, x, y, steps=10, base="adam", compiled=False, **kw):
    """``steps`` steps of the MLP under ``DistributedOptimizer(**kw)``
    over torch Adam or SGD at 1e-2, eagerly or through
    ``compiled_train_step`` (a zero3 stripe loaded by ``shard_params``
    first and read back by ``unshard_params``). Returns (parameters,
    losses, optimizer)."""
    model = _MLP(inp["params"])
    cls = torch.optim.Adam if base == "adam" else torch.optim.SGD
    opt = hvd.DistributedOptimizer(cls(model.parameters(), lr=1e-2),
                                   named_parameters=model.named_parameters(),
                                   **kw)
    step = hvd.compiled_train_step(model.loss, opt) if compiled else None
    if step is not None and step._resident:
        step.shard_params()
    losses = []
    for _ in range(steps):
        if step is not None:
            loss = step(x, y)
        else:
            opt.zero_grad(set_to_none=True)
            loss = model.loss(x, y)
            loss.backward()
            opt.step()
        losses.append(float(loss))
    if step is not None:
        assert step.fallback_steps == 0
    if step is not None and step._resident:
        out = {k: v.numpy() for k, v in zip(
            ("b1", "b2", "w1", "w2"), step.unshard_params())}
    else:
        out = model.numpy()
    return out, losses, opt


def _stages(family):
    vals = family.collect()
    return vals.get('stage="ici"', 0.0), vals.get('stage="dcn"', 0.0)


def zero(inp):
    """Every case of tests/test_torch_zero.py on this rank: the ladder,
    its compiled forms, the zero3 layout, the staged scatter and gather,
    compressed training, the residual's state and the metric
    families."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.ops import collectives as C
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    rows = slice(4 * r, 4 * r + 4)
    x = torch.from_numpy(inp["x"][rows])
    y = torch.from_numpy(inp["y"][rows])
    out = {"rank": r, "size": n}
    for name, kw in (("zero0", {}), ("zero1", {"zero_stage": 1}),
                     ("reduce_scatter", {"reduce_scatter": True}),
                     ("zero2", {"zero_stage": 2}),
                     ("zero3", {"zero_stage": 3}),
                     ("zero2_b64", {"zero_stage": 2, "bucket_bytes": 64}),
                     ("zero2_fp16", {"zero_stage": 2,
                                     "compression": hvd.Compression.fp16}),
                     ("dcn0_bf16", {"dcn_compression": "bf16",
                                    "dcn_local_size": 2})):
        out[name], _, opt = _zero_train(inp, x, y, **kw)
        out[f"mode:{name}"] = opt._hvd_exchange
    for name, base, kw in (("c_zero0", "adam", {}),
                           ("c_zero2", "adam", {"zero_stage": 2}),
                           ("c_zero3_adam", "adam", {"zero_stage": 3}),
                           ("c_zero0_sgd", "sgd", {}),
                           ("c_zero3_sgd", "sgd", {"zero_stage": 3})):
        out[name], _, _ = _zero_train(inp, x, y, base=base, compiled=True,
                                      **kw)
    # compressed training against the uncompressed trajectory, 12 steps
    for name, dcn in (("c12", ""), ("c12_bf16", "bf16"),
                      ("c12_int8", "int8")):
        out[name], out[f"loss:{name}"], _ = _zero_train(
            inp, x, y, steps=12, compiled=True, zero_stage=2,
            dcn_compression=dcn, dcn_local_size=2 if dcn else 0)

    # the zero3 layout: the stripe, the Adam state over it, the round trip
    model = _MLP(inp["params"])
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-2),
        named_parameters=model.named_parameters(), zero_stage=3)
    step = hvd.compiled_train_step(model.loss, opt)
    full = [p.detach().clone() for p in model.parameters()]
    stripe = step.shard_params()
    out["stripe_len"] = stripe.numel()
    out["stripe"] = stripe.detach().numpy().copy()
    out["roundtrip_exact"] = all(torch.equal(a, b) for a, b in
                                 zip(full, step.unshard_params()))
    step(x, y)
    out["adam_state_shapes"] = [tuple(v.shape) for v in
                                opt.state_dict()["state"][0].values()]
    out["stripe_gauges"] = metrics.ZERO_STRIPE_BYTES.collect()

    # the staged scatter and gather, exact and compressed
    g = torch.from_numpy(inp["rows"][r])
    for local in (1, 2, 4):
        stripe, res = C.dcn_staged_psum_scatter(g, local=local)
        out[f"staged{local}"] = C.dcn_staged_all_gather(
            stripe, local=local).numpy()
        out[f"staged_res{local}"] = res
        out[f"sigma{local}"] = C.dcn_sigma(None, local)
    c = torch.from_numpy(inp["crows"][r])
    for comp in ("bf16", "int8"):
        res0 = torch.zeros(c.shape[0] // 2)
        stripe, res = C.dcn_staged_psum_scatter(
            c, local=2, dcn_compression=comp, residual=res0)
        out[f"full_{comp}"] = C.dcn_staged_all_gather(
            stripe, local=2, dcn_compression=comp).numpy()
        out[f"res_{comp}"] = res.numpy()
        out[f"stripe_{comp}"] = stripe.numpy()

    # the stripe a rank owns under staging (local 2): segment sigma(r)
    model = _MLP(inp["params"])
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=1e-2),
        named_parameters=model.named_parameters(), zero_stage=1,
        dcn_compression="bf16", dcn_local_size=2)
    out["staged_stripe"] = opt.stripe.detach().numpy().copy()
    out["state_kinds"] = [type(o.zero_state()).__name__ for o in (
        opt, hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters(), zero_stage=1),
        hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters(),
            dcn_compression="int8", dcn_local_size=2))]

    # the residual is optimizer state
    for name, kw in (("int8", {"dcn_compression": "int8",
                               "dcn_local_size": 2}), ("plain", {})):
        model = _MLP(inp["params"])
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters(), zero_stage=2, **kw)
        res = opt.state_dict()["dcn_residual"]
        out[f"residual:{name}"] = None if res is None \
            else res.numpy().copy()
        out[f"state_residual:{name}"] = opt.zero_state().residual is res
        if res is not None:
            model.loss(x, y).backward()
            opt.step()
            sd = opt.state_dict()
            out["residual_after_step"] = sd["dcn_residual"].numpy().copy()
            opt2 = hvd.DistributedOptimizer(
                torch.optim.Adam(_MLP(inp["params"]).parameters(),
                                 lr=1e-2), zero_stage=2, **kw)
            opt2.load_state_dict(sd)
            out["residual_loaded"] = opt2.state_dict()["dcn_residual"] \
                .numpy()
            # broadcast_optimizer_state keeps each rank's stripe state
            mine = sd["state"][0]["exp_avg"].clone()
            hvd.broadcast_optimizer_state(opt, root_rank=0)
            out["stripe_state_kept"] = torch.equal(
                opt.state_dict()["state"][0]["exp_avg"], mine)
            out["exp_avg"] = mine.numpy().copy()

    # the metric families over 2 compiled int8 steps
    stats = hvd.runtime.live_state().stats
    jit0 = stats.jit_records()
    w0 = _stages(metrics.WIRE_STAGE_BYTES)
    r0 = _stages(metrics.WIRE_STAGE_RAW_BYTES)
    _zero_train(inp, x, y, steps=2, compiled=True, zero_stage=2,
                dcn_compression="int8", dcn_local_size=2)
    out["wire"] = [a - b for a, b in zip(_stages(metrics.WIRE_STAGE_BYTES),
                                         w0)]
    out["raw"] = [a - b for a, b in zip(
        _stages(metrics.WIRE_STAGE_RAW_BYTES), r0)]
    out["zero_stage_gauge"] = metrics.ZERO_STAGE.value()
    out["jit"] = {k: v - jit0.get(k, 0) for k, v in
                  stats.jit_records().items() if v != jit0.get(k, 0)}
    hvd.shutdown()
    return out


# ------------------------------------------------------- sharding spec

def _compiled(model, opt, batch, steps):
    step = hvd.compiled_train_step(model.loss, opt)
    if step._resident:
        step.shard_params()
    for _ in range(steps):
        step(*batch)
    assert step.fallback_steps == 0
    return step


def sharding_spec(inp, cfg_kw, steps, lr):
    """tests/test_torch_sharding_spec.py's cases on this rank of the 2
    data x 2 expert layout (HOROVOD_EXPERT_PARALLEL=2): the 1-D ladder's
    exchanges (psum, zero1-3) against the same layouts spelled as a
    ``_ShardingSpec``, then one MoE layer trained through the moe fast
    path, its spec spelling and the expert x ZeRO x DCN combinations,
    ``steps`` compiled SGD (or Adam) steps each."""
    from horovod_tpu_torch.ops.compression import Compression
    from horovod_tpu_torch.optimizers import (
        _DistributedOptimizer, _mix, _named, _ShardingSpec, _zero_sharded)
    hvd.init(device="cpu")
    r = hvd.rank()
    ep = hvd.expert_parallel_size()
    group = hvd.expert_mesh().get_group("ep")
    out = {"rank": r}

    def spec_hooks(base, model, spec):
        named = _named(base, model.named_parameters())
        return _mix(base, _DistributedOptimizer)(
            base.param_groups, named, Compression.none, 1, 1, spec, "spec")

    def spec_zero(base, model, stage, spec):
        return _zero_sharded(base, _named(base, model.named_parameters()),
                             Compression.none, 1, stage, "", 0, None, None,
                             spec)

    rows = slice(4 * r, 4 * r + 4)
    batch = (torch.from_numpy(inp["x"][rows]),
             torch.from_numpy(inp["y"][rows]))
    cases = {"psum": (torch.optim.SGD, 0.1, {}, lambda b, m: spec_hooks(
        b, m, _ShardingSpec()))}
    for stage in (1, 2, 3):
        cases[f"zero{stage}"] = (
            torch.optim.Adam, 1e-2, {"zero_stage": stage},
            lambda b, m, s=stage: spec_zero(b, m, s,
                                            _ShardingSpec(zero_stage=s)))
    for name, (cls, rate, kw, as_spec) in cases.items():
        for form in ("direct", "spec"):
            model = _MLP(inp["params"])
            base = cls(model.parameters(), lr=rate)
            opt = (hvd.DistributedOptimizer(
                base, named_parameters=model.named_parameters(), **kw)
                if form == "direct" else as_spec(base, model))
            step = _compiled(model, opt, batch, 5)
            out[f"{name}:{form}"] = (
                [t.numpy() for t in step.unshard_params()] if step._resident
                else [p.detach().numpy().copy() for p in model.parameters()])
            out[f"mode:{name}:{form}"] = step._exchange

    cfg = moe.MoEConfig(dtype=torch.float32, **cfg_kw)
    full = {k: torch.from_numpy(inp[k]) for k in ("w1", "w2", "w_router")}
    mine = moe.expert_slice(full, r % ep, ep)
    mbatch = (torch.from_numpy(inp["mx"][r]), torch.from_numpy(inp["my"][r]))
    keys = ("w1", "w2")
    dcn = {"dcn_compression": "bf16", "dcn_local_size": 2}
    moe_cases = {
        "moe": (torch.optim.SGD, {"expert_keys": keys}),
        "moe_spec": (torch.optim.SGD, None),
        "moe_zero2": (torch.optim.SGD, {"expert_keys": keys,
                                        "zero_stage": 2}),
        "moe_zero2_dcn": (torch.optim.SGD, {"expert_keys": keys,
                                            "zero_stage": 2, **dcn}),
        "moe_dcn": (torch.optim.SGD, {"expert_keys": keys, **dcn}),
        "moe_zero2_staged": (torch.optim.SGD, {
            "expert_keys": keys, "zero_stage": 2,
            "dcn_compression": "bf16", "dcn_local_size": 1}),
        "adam_zero2_dcn": (torch.optim.Adam, {"expert_keys": keys,
                                              "zero_stage": 2, **dcn}),
        "adam_zero0_dcn": (torch.optim.Adam, {"expert_keys": keys, **dcn}),
        "zero2_only": (torch.optim.SGD, {"zero_stage": 2}),
    }
    for name, (cls, kw) in moe_cases.items():
        local = name == "zero2_only"
        model = _MoELoss(full if local else mine, cfg,
                         None if local else group, chunks=1)
        base = cls(model.parameters(), lr=lr if cls is torch.optim.SGD
                   else 1e-2)
        if kw is None:
            opt = spec_hooks(base, model, _ShardingSpec(
                "hvd", "ep", keys))
        else:
            opt = hvd.DistributedOptimizer(
                base, named_parameters=model.named_parameters(), **kw)
        step = _compiled(model, opt, mbatch,
                         5 if name.startswith("adam") else steps)
        out[name] = {k: v.detach().numpy().copy()
                     for k, v in model.moe.items()}
        out[f"mode:{name}"] = step._exchange
        if kw and "dcn_compression" in kw:
            out[f"spec:{name}"] = (opt._spec.mesh_axes,
                                   opt._spec.dcn_link)
    from horovod_tpu_torch import metrics
    out["spec_leaves"] = metrics.SPEC_LEAVES.collect()
    hvd.shutdown()
    return out


# ------------------------------------------------ tensor parallelism

def _tree(arrays):
    """A numpy parameter tree as CPU tensors."""
    from horovod_tpu_torch.models import transformer as tfm
    return tfm.params_from_jax(arrays["tree"], arrays["cfg"], "cpu")


def _np_named(tree):
    from horovod_tpu_torch.models import transformer as tfm
    return {k: v.detach().numpy().copy()
            for k, v in tfm._named_leaves(tree)}


def _teacher_forced(eng, tokens, prompt):
    """Prefill the prompt, then feed the remaining columns one decode
    step at a time; the logits rows of positions prompt-1 .. L-1."""
    b, length = tokens.shape
    sids = list(range(b))
    for s in sids:
        eng.cache.allocate(s, length)
    outs = [eng.prefill(sids, [list(tokens[i, :prompt]) for i in sids])]
    for i in range(prompt, length):
        outs.append(eng.decode(sids, tokens[:, i], [i] * b))
    return np.stack(outs)


def tensor_parallel(inp):
    """tests/test_torch_tensor_parallel.py's cases on this rank of a
    model group of 2 (``HOROVOD_MODEL_PARALLEL=2``): the runtime's model
    mesh; per-shard losses and gradients of the sharded trunk; TP with a
    local ring; generate and a head-sharded decode cache; the TP serve
    engine, driven directly and through lockstep batchers and the API
    whose requests reach the two ranks at different times; the shards of
    the weights converter gathered back."""
    import time

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    from horovod_tpu_torch.serve import Engine
    from horovod_tpu_torch.serve.engine import ServeEngine
    from horovod_tpu_torch.serve.scheduler import ContinuousBatcher, Request
    hvd.init(device="cpu")
    r = hvd.rank()
    mesh = hvd.model_mesh()
    tp = mesh.get_group("model")
    axes = tfm.ShardAxes(tp=tp)
    out = {"rank": r, "mesh": mesh.mesh.tolist(),
           "names": mesh.mesh_dim_names, "mp": hvd.model_parallel_size(),
           "gauge": metrics.MODEL_PARALLEL.collect()}

    for name, case in inp["grads"].items():
        cfg = case["cfg"]
        full = _tree(case)
        shard = tfm.slice_param_shards(full, tfm.param_specs(cfg), mesh)
        model = tfm.TransformerLM(cfg, shard, device="cpu", axes=axes)
        tokens, targets = map(torch.from_numpy, case["batch"])
        loss = model.loss(tokens, targets)
        loss.backward()
        ref = tfm.TransformerLM(cfg, full, device="cpu")
        ref_loss = ref.loss(tokens, targets)
        ref_loss.backward()
        out[f"grads:{name}"] = (float(loss), {
            k: v.grad.numpy().copy()
            for k, v in tfm._named_leaves(model.params)})
        out[f"unsharded:{name}"] = (float(ref_loss), {
            k: v.grad.numpy().copy()
            for k, v in tfm._named_leaves(ref.params)})

    case = inp["ring"]
    full = _tree(case)
    shard = tfm.slice_param_shards(full, tfm.param_specs(case["cfg"]), mesh)
    tokens, targets = map(torch.from_numpy, case["batch"])
    out["ring"] = float(tfm.loss_fn(
        shard, tokens, targets, case["cfg"],
        tfm.ShardAxes(tp=tp, sp=RingAxis.local(2))))

    for name, case in inp["generate"].items():
        cfg = case["cfg"]
        shard = tfm.slice_param_shards(_tree(case), tfm.param_specs(cfg),
                                       mesh)
        prompt = torch.from_numpy(case["prompt"])
        out[f"generate:{name}"] = tfm.generate(
            shard, prompt, cfg, 6, axes=axes).numpy()
        cache = tfm.init_cache(cfg, 2, 8, axes, device="cpu")
        logits, _ = tfm.decode_step(shard, cache, prompt[:, 0], cfg, axes)
        out[f"cache:{name}"] = (tuple(cache["layers"][0]["k"].shape),
                                tuple(logits.shape))

    case = inp["serve"]
    cfg = case["cfg"]
    full = _tree(case)
    tokens = case["tokens"]
    kw = dict(num_pages=16, page_size=4, batch_bin_floor=tokens.shape[0],
              page_bin_floor=2, len_bin_floor=tokens.shape[1], device="cpu")
    out["serve_ref"] = _teacher_forced(ServeEngine(full, cfg, **kw),
                                       tokens, 4)
    eng = ServeEngine(full, cfg, mesh=mesh, tp_axis="model", **kw)
    out["serve_tp"] = _teacher_forced(eng, tokens, 4)
    out["pool"] = tuple(eng._k_pool.shape)

    def requests():
        return [Request(list(p), 6) for p in case["prompts"]]

    def run(batcher, lag):
        reqs = requests()
        for q in reqs:
            if lag:
                time.sleep(0.1)
            batcher.submit(q)
        batcher.drain()
        return [q.generated for q in reqs]

    kw = dict(num_pages=32, page_size=4, device="cpu")
    out["batcher_ref"] = run(ContinuousBatcher(
        ServeEngine(full, cfg, **kw), max_batch=2), False)
    out["batcher_tp"] = run(ContinuousBatcher(
        ServeEngine(full, cfg, mesh=mesh, tp_axis="model", **kw),
        max_batch=2), lag=r == 1)
    api = Engine(cfg, full, mesh=mesh, tp_axis="model", max_batch=2,
                 **kw)
    handles = []
    for p in case["prompts"]:
        if r == 0:
            time.sleep(0.1)
        handles.append(api.submit(list(p), 6))
    out["api_tp"] = [h.result() for h in handles]
    api.close()

    # the converter's shards, gathered back over the group
    case = inp["convert"]
    cfg = case["cfg"]
    full = _tree(case)
    specs = tfm.param_specs(cfg)
    shard = tfm.slice_param_shards(full, specs, mesh)
    worst = 0.0
    for (name, part), (_, spec), (_, whole) in zip(
            tfm._named_leaves(shard), tfm._named_leaves(specs),
            tfm._named_leaves(full)):
        if "model" in spec:
            parts = [torch.empty_like(part) for _ in range(2)]
            dist.all_gather(parts, part, group=tp)
            part = torch.cat(parts, dim=spec.index("model"))
        worst = max(worst, float((part - whole).abs().max()))
    out["roundtrip"] = worst
    hvd.shutdown()
    return out


def mesh3d(inp):
    """tests/test_torch_tensor_parallel.py's 3-D case on this rank of the
    2 x 2 x 2 (data, expert, model) mesh: a tensor-parallel trunk with an
    expert-parallel MoE layer trained by 3 compiled SGD steps through
    the sharding spec at ZeRO stages 2 and 0, from the same shards."""
    from horovod_tpu_torch.models import transformer as tfm
    hvd.init(device="cpu")
    r = hvd.rank()
    mesh = hvd.model_mesh()
    cfg = inp["cfg"]
    axes = tfm.ShardAxes(tp=mesh.get_group("model"),
                         ep=mesh.get_group("ep"))
    model_keys = tfm.model_parallel_keys(cfg)
    full = _tree(inp)
    # the batch shards over data x expert, the same on a model group
    shard = r // hvd.model_parallel_size()
    tokens, targets = (torch.from_numpy(a[2 * shard:2 * shard + 2])
                       for a in inp["batch"])
    out = {"rank": r, "mesh": mesh.mesh.tolist(),
           "shape": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}
    for stage in (2, 0):
        model = tfm.TransformerLM(
            cfg, tfm.slice_param_shards(full, tfm.param_specs(cfg), mesh),
            device="cpu", axes=axes)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05),
            named_parameters=model.named_parameters(),
            expert_keys=("moe.w1", "moe.w2"), model_keys=model_keys,
            zero_stage=stage)
        step = hvd.compiled_train_step(model.loss, opt)
        for _ in range(3):
            step(tokens, targets)
        assert step.fallback_steps == 0
        out[f"mode:{stage}"] = step._exchange
        out[f"zero{stage}"] = _np_named(model.params)
    from horovod_tpu_torch import metrics
    out["spec_leaves"] = metrics.SPEC_LEAVES.collect()
    hvd.shutdown()
    return out


def tp_card(model):
    """One rank of a model group of 2 on one card, over gloo: the group
    is made here (``hvd.init()`` takes a group that exists, NCCL refuses
    two ranks on one card), then the TP loss and greedy tokens of
    ``model`` against the unsharded model's, with the launches by
    route."""
    import os

    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serve.engine import ServeEngine
    from horovod_tpu_torch.serve.scheduler import ContinuousBatcher, Request
    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    os.environ.update(HOROVOD_MODEL_PARALLEL="2", HOROVOD_STEP_PROGRAM="0")
    # the launcher's coordinator address: init() takes this group and
    # makes no store of its own there
    dist.init_process_group(
        "gloo", init_method="tcp://" + os.environ["HOROVOD_TPU_COORDINATOR"],
        rank=int(os.environ["HOROVOD_TPU_PROCESS_ID"]), world_size=2)
    hvd.init(device=card)
    mesh = hvd.model_mesh()
    cfg = tfm.TransformerConfig(loss_chunk=64, **model)
    full = tfm.init_params(cfg, torch.Generator().manual_seed(0), card)
    shard = tfm.slice_param_shards(full, tfm.param_specs(cfg), mesh)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 128))).to(card)
    targets = torch.roll(tokens, -1, dims=1)

    def greedy(eng):
        batcher = ContinuousBatcher(eng, max_batch=2)
        reqs = [Request(list(range(3 + i, 40 + i)), 8) for i in range(2)]
        for q in reqs:
            batcher.submit(q)
        batcher.drain()
        return [q.generated for q in reqs]

    out = {"ref_loss": float(tfm.loss_fn(full, tokens, targets, cfg)),
           "ref_tokens": greedy(ServeEngine(full, cfg, device=card))}
    for c in [c for c in vars(fa) if c.endswith("launches")]:
        setattr(fa, c, 0)
    lm = tfm.TransformerLM(cfg, shard, device=card,
                           axes=tfm.ShardAxes(tp=mesh.get_group("model")))
    loss = lm.loss(tokens, targets)
    loss.backward()
    eng = ServeEngine(full, cfg, mesh=mesh, tp_axis="model", device=card)
    out.update(loss=float(loss), tokens=greedy(eng),
               h_kv=eng._k_pool.shape[3],
               launches={k: getattr(fa, p + "launches") for k, p in (
                   ("flash_fwd", ""), ("flash_fwd_wgmma", "wgmma_"),
                   ("flash_bwd_dq_wgmma", "dq_wgmma_"),
                   ("flash_bwd_dkv_wgmma", "dkv_wgmma_"))})
    hvd.shutdown()
    dist.destroy_process_group()
    return out


# ------------------------------------------ Ulysses sequence parallelism

def _sp_shard(x, j, n, dim=1):
    size = x.shape[dim] // n
    return x.narrow(dim, j * size, size).clone()


def ulysses(inp):
    """tests/test_torch_ulysses.py's process-group cases on this rank of
    8: ``ulysses_attention`` over the sp group of ``create_mesh(sp=n)``
    (n 2, 4, 8; dp takes the rest) per shard, forward and gradients;
    then each model case's loss over the dp 2 x sp 2 x tp 2 mesh, the
    sequence shard's mean averaged over the sp group by ``loss_fn`` and
    over the dp group here."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention
    hvd.init(device="cpu")
    n = hvd.size()
    out = {"rank": hvd.rank()}
    q, k, v = (torch.from_numpy(inp["attn"][x]) for x in "qkv")
    for sp in (2, 4, 8):
        mesh = create_mesh("cpu", n, sp=sp)
        axis = RingAxis.over(mesh.get_group("sp"))
        j = axis.shards[0]
        out[f"shard{sp}"] = (j, mesh.get_local_rank("sp"))
        for causal in (True, False):
            got = ulysses_attention(*(_sp_shard(x, j, sp) for x in (q, k, v)),
                                    axis, causal=causal)
            out[f"attn{sp}{causal}"] = got.numpy()
    mesh = create_mesh("cpu", n, sp=4)
    axis = RingAxis.over(mesh.get_group("sp"))
    j = axis.shards[0]
    gq, gk, gv = (torch.from_numpy(inp["grad"][x]) for x in "qkv")
    shards = [_sp_shard(x, j, 4).requires_grad_() for x in (gq, gk, gv)]
    (ulysses_attention(*shards, axis, causal=True) ** 2).sum().backward()
    out["grad"] = [x.grad.numpy() for x in shards]

    mesh = create_mesh("cpu", n, dp=2, sp=2, tp=2)
    axes = tfm.ShardAxes(sp=RingAxis.over(mesh.get_group("sp")),
                         tp=mesh.get_group("tp"))
    di, si = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    for name, case in inp["models"].items():
        cfg = case["cfg"]
        shard = tfm.slice_param_shards(_tree(case),
                                       tfm.param_specs(cfg, tp="tp"), mesh)
        tokens, targets = (_sp_shard(_sp_shard(torch.from_numpy(a), di, 2, 0),
                                     si, 2) for a in case["batch"])
        loss = tfm.loss_fn(shard, tokens, targets, cfg, axes).detach()
        dist.all_reduce(loss, group=mesh.get_group("dp"))
        out[f"model:{name}"] = float(loss) / 2
    hvd.shutdown()
    return out


# ------------------------------------------------ pipeline parallelism

def _toy_1f1b(axis, inp, m, v, gated):
    """The reference's toy 4-virtual-stage pipeline (tanh(x * w_stage),
    inject by ``win``, MSE loss against the microbatch index) through
    ``pipeline_1f1b`` on this rank's block of the stage weights."""
    from horovod_tpu_torch.parallel.pipeline import pipeline_1f1b
    s = axis.shards[0]
    w = torch.from_numpy(inp["w"])
    w = w[s:s + 1] if v == 1 else w.reshape(v, -1)[:, s:s + 1]
    shared = {k: torch.tensor(x) for k, x in inp["shared"].items()}
    runs = {"fwd": 0, "bwd": 0}

    def stage_fn(sp, x):
        runs["bwd" if torch.is_grad_enabled() else "fwd"] += 1
        return torch.tanh(x * sp[0])

    loss, d_w, d_sh = pipeline_1f1b(
        stage_fn, w, shared, torch.from_numpy(inp["xs"][:m]), axis,
        num_microbatches=m, inject_fn=lambda sh, raw: raw * sh["win"],
        loss_fn=lambda sh, y, mb: torch.mean((y * sh["wout"] - mb) ** 2),
        num_chunks=v, stage_collectives=not gated)
    return (float(loss), d_w.numpy(), {k: float(g) for k, g in d_sh.items()},
            runs)


def pipelines(inp):
    """tests/test_torch_pipeline.py's process-group cases on this rank of
    8, each on its own ``create_mesh`` (dp takes the ranks the case
    leaves): the toy GPipe and 1F1B schedules, the pipelined
    transformer's losses and per-rank gradients (GPipe under autograd,
    1F1B, interleaved, loss_chunk, MoE over an expert group), with this
    rank's coordinates on each mesh."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.pipeline import last_stage_value, pipeline
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    hvd.init(device="cpu")
    n = hvd.size()
    out = {"rank": hvd.rank()}
    meshes = {}

    def mesh_of(**kw):
        key = tuple(sorted(kw.items()))
        if key not in meshes:
            meshes[key] = create_mesh("cpu", n, **kw)
            out[f"mesh{key}"] = meshes[key].mesh.tolist()
        return meshes[key]

    def coords(mesh):
        return {a: (mesh.get_local_rank(a), mesh.size(i))
                for i, a in enumerate(mesh.mesh_dim_names)}

    # the toy 2-stage GPipe
    mesh = mesh_of(pp=2)
    axis = RingAxis.over(mesh.get_group("pp"))
    w = torch.tensor([2.0, 3.0])
    got = pipeline(lambda s, x: x * w[s], torch.arange(12.0).reshape(4, 3),
                   axis, num_microbatches=4)
    out["toy_gpipe"] = last_stage_value(got, axis).numpy()

    # the toy 1F1B: core, interleaved and gated
    for key, (m, v, gated) in inp["toys"].items():
        mesh = mesh_of(pp=4 // v)
        pp = RingAxis.over(mesh.get_group("pp"))
        out[f"toy:{key}"] = (coords(mesh)["pp"],
                             _toy_1f1b(pp, inp["toy"], m, v, gated))

    # the transformer
    for key, case in inp["models"].items():
        cfg, kw = case["cfg"], case["mesh"]
        mesh = mesh_of(**kw)
        v = case.get("interleave", 1)
        full = tfm.stack_pipeline_params(_tree(case), interleave=v,
                                         num_stages=kw["pp"])
        specs = tfm.pipeline_param_specs(cfg, tp="tp", interleave=v,
                                         num_stages=kw["pp"])
        shard = tfm.slice_param_shards(full, specs, mesh)
        axes = tfm.ShardAxes(
            sp=(RingAxis.over(mesh.get_group("sp")) if kw.get("sp", 1) > 1
                else None),
            tp=mesh.get_group("tp") if kw.get("tp", 1) > 1 else None,
            ep=mesh.get_group("ep") if kw.get("ep", 1) > 1 else None)
        si, sn = mesh.get_local_rank("sp"), kw.get("sp", 1)
        tokens, targets = (_sp_shard(torch.from_numpy(a), si, sn)
                           for a in case["batch"])
        pp = RingAxis.over(mesh.get_group("pp"))
        res = {"coords": coords(mesh)}
        if "gpipe" in case["runs"]:
            for t in tfm._leaves(shard):
                t.requires_grad_()
            loss = tfm.pipeline_loss_fn(shard, tokens, targets, cfg, axes,
                                        num_microbatches=4, pp=pp)
            loss.backward()
            res["gpipe"] = (loss.item(), {
                k: t.grad.numpy().copy() for k, t in tfm._named_leaves(shard)})
            for t in tfm._leaves(shard):
                t.grad = None
        if "1f1b" in case["runs"]:
            loss, grads = tfm.pipeline_value_and_grad_1f1b(
                shard, tokens, targets, cfg, axes, num_microbatches=4, pp=pp,
                interleave=v)
            res["1f1b"] = (loss.item(), {k: t.numpy().copy()
                                         for k, t in tfm._named_leaves(grads)})
        out[f"model:{key}"] = res
    hvd.shutdown()
    return out



def stall_desync(diag_dir):
    """The hang watchdog over gloo ranks (HOROVOD_STALL_TIMEOUT_SECONDS
    0.5): rank 1 enters the named all-reduce ``diag.stall`` 2 s after
    rank 0, then both finish it. Returns the sum, whether rank 0's
    watchdog wrote its dump and desync report, and their contents."""
    import os
    import time

    hvd.init(device="cpu")
    try:
        r = hvd.rank()
        if r == 1:
            time.sleep(2.0)
        out = hvd.allreduce(torch.full((4,), float(r + 1)), average=False,
                            name="diag.stall")
        dump = os.path.join(diag_dir, f"flight-rank{r}.json")
        report = os.path.join(diag_dir, "desync-report.json")
        return {"sum": out.numpy().copy(),
                "dump": (json.load(open(dump)) if os.path.exists(dump)
                         else None),
                "report": (json.load(open(report))
                           if r == 0 and os.path.exists(report) else None)}
    finally:
        hvd.shutdown()


def telemetry_skew(delay):
    """TelemetryCallback's straggler skew over gloo ranks: rank r's step
    sleeps ``delay * (r + 1)``; the skew sample (every step) allgathers
    the step times. Returns the skew gauges."""
    import time

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.callbacks import TelemetryCallback
    hvd.init(device="cpu")
    try:
        cb = TelemetryCallback(batch_size=4, skew_interval=1)
        for i in range(2):
            cb.on_batch_begin(i)
            time.sleep(delay * (hvd.rank() + 1))
            cb.on_batch_end(i)
        return {"skew": metrics.STEP_SKEW.value(),
                "max": metrics.STEP_SKEW_MAX.value(),
                "median": metrics.STEP_SKEW_MEDIAN.value(),
                "steps": cb._steps,
                "examples": metrics.EXAMPLES_PER_SEC.value()}
    finally:
        hvd.shutdown()


def moe_bench_trace():
    """bench.transformer's MoE scenario over an expert group of 2 gloo
    ranks, chunks 2, at a small width: its ``moe`` row, whose trace keys
    read the all-to-all, and the traced steps' all-to-alls a step by
    phase (:func:`host_op_phases`)."""
    import collections
    import os

    from horovod_tpu_torch.bench import transformer as tfm_bench
    os.environ["HOROVOD_PROFILER_DISABLE"] = "1"
    try:
        row = tfm_bench.run_moe_benchmark(tfm_bench.parse_args(
            ["--moe", "--expert-parallel", "2", "--moe-chunks", "2",
             "--moe-d-model", "64", "--moe-d-ff", "128", "--moe-batch",
             "8", "--moe-seq", "16", "--iters", "1", "--device", "cpu"]))[
                 "moe"]
    finally:
        hvd.shutdown()
    ops = host_op_phases(row["xla_trace_dir"], ("c10d::alltoall_base_",))
    row["alltoalls_per_step"] = {
        phase: n / tfm_bench.TRACE_STEPS for phase, n in
        collections.Counter(phase for _, phase in ops).items()}
    return row


def scaling_steps(batch_per_chip, hidden, depth, snapshots):
    """bench/scaling.py's harness step on this rank: its parameters (as
    numpy) after each step count in ``snapshots``."""
    from horovod_tpu_torch.bench import scaling
    hvd.init(device="cpu")
    h = scaling.Harness(batch_per_chip, hidden, depth)
    out, done = {}, 0
    for k in snapshots:
        while done < k:
            h.step()
            done += 1
        out[k] = h.numpy_params()
    hvd.shutdown()
    return out


class _ScaledMoELoss(_MoELoss):
    """``_MoELoss`` of ``x * scale``, ``scale`` a learned (d,) vector, so
    that the tokens the layer dispatches carry a gradient back."""

    def __init__(self, params, cfg, group, chunks):
        super().__init__(params, cfg, group, chunks)
        self.scale = torch.nn.Parameter(torch.ones(cfg.d_model))

    def loss(self, x, target):
        return super().loss(x * self.scale, target)


def host_op_phases(trace_dir, names):
    """``[(host op, phase)]`` of a capture's ops named in ``names``, each
    given the phase of the ``hvd_`` ranges around it, as the tracer's
    parser joins them (by time, across threads)."""
    from horovod_tpu_torch.diag import xla_trace
    out = []
    for path in xla_trace._iter_trace_files(trace_dir):
        events = xla_trace._load_trace_events(path)
        ops = [ev for ev in xla_trace._complete(events, ("cpu_op",))
               if ev["name"] in names]
        paths = xla_trace._scope_paths(
            [(ev["ts"], i) for i, ev in enumerate(ops)],
            xla_trace._phase_ranges(events))
        out += [(ev, xla_trace.phase_of_op_name(paths.get(i)))
                for i, ev in enumerate(ops)]
    return out


def moe_phase_ops(inp, cfg_kw, chunks, names, out_dir):
    """One traced compiled SGD step of ``_ScaledMoELoss`` over the
    expert group at each count of ``chunks``: ``{chunks: {(op, phase):
    n}}`` for the host ops named in ``names`` (:func:`host_op_phases`)."""
    import collections
    import os

    from horovod_tpu_torch.diag import xla_trace
    hvd.init(device="cpu")
    r = hvd.rank()
    ep = hvd.expert_parallel_size()
    group = hvd.expert_mesh().get_group("ep")
    cfg = moe.MoEConfig(dtype=torch.float32, **cfg_kw)
    full = {k: torch.from_numpy(inp[k]) for k in ("w_router", "w1", "w2")}
    x = torch.from_numpy(inp["x"][r])
    target = torch.from_numpy(inp["target"][r])
    out = {}
    for k in chunks:
        model = _ScaledMoELoss(moe.expert_slice(full, r % ep, ep), cfg,
                               group, k)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05),
            named_parameters=model.named_parameters(),
            expert_keys=("w1", "w2"))
        step = hvd.compiled_train_step(model.loss, opt, name=f"moe.{k}")
        step(x, target)
        tr = hvd.trace_steps(1, out_dir=os.path.join(out_dir, f"rank{r}",
                                                     f"c{k}"))
        for _ in range(2):
            step(x, target)
        xla_trace.uninstall()
        out[k] = collections.Counter(
            (ev["name"], phase)
            for ev, phase in host_op_phases(tr.last_dir, names))
    hvd.shutdown()
    return out
