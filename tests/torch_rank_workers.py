"""What each gloo rank runs in tests/test_torch_collectives.py and the
expert-parallel cases of tests/test_torch_moe.py (through
tests/torch_ranks.py's ``spawn_ranks``). No JAX here: every rank
imports this module. Each function returns numpy arrays and plain
values, which the test compares with the JAX package in its own
process."""

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
    mesh = hvd.expert_mesh()
    out["ep_size"] = hvd.expert_parallel_size()
    out["coordinate"] = mesh.get_coordinate()
    out["ep_group"] = dist.get_process_group_ranks(mesh.get_group("ep"))
    out["data_group"] = dist.get_process_group_ranks(mesh.get_group("hvd"))
    hvd.shutdown()
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
