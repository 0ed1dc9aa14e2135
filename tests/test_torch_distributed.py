"""The port's runtime, collectives and DistributedOptimizer over 2 gloo
ranks, against the JAX package.

A rank of the port is a process, so the multi-rank cases run in two
processes started with the JAX launcher's variables
(``HOROVOD_TPU_COORDINATOR`` and the rest; tests/torch_ranks.py), each
running ``WORKER`` below on the CPU. Spawning costs seconds, so one module-scoped run of
both processes covers every multi-rank case and the tests read its
results: ``allreduce`` (average and sum), ``grouped_allreduce``,
``allgather``, ``broadcast``, ``broadcast_parameters``,
``broadcast_optimizer_state``, ``DistributedOptimizer`` with 1 and 3
buckets, ``backward_passes_per_step=2`` and fp16 compression, and three
steps of the small transformer, each rank on half the batch, against
``hvd.DistributedOptimizer(optax.adamw(...))`` of the JAX package inside
``jax.shard_map`` over 2 of the conftest's virtual devices (the pattern
of ``bench_transformer.build_step``). The same run holds ring attention
over the process group (one shard a rank, ``batch_isend_irecv`` over
gloo) and the sequence-parallel transformer over it to the local ring of
2 in this process.

Tolerances: collectives of f32 values are exact up to the order of a
two-term sum (atol 1e-6); fp16 compression rounds each gradient to fp16
on the wire (rtol 2e-3). The transformer's parameters after each of 3
AdamW steps: per leaf, the L2 distance between the two packages'
parameters is at most 1e-3 of the distance the parameters moved from
their start. Not elementwise: AdamW's first steps move each element by
about ``lr * g / (|g| + eps)``, so an element whose gradient cancels to
~5e-8 moves by an amount that the f32 summation order of its gradient
changes by several percent (1.4e-5 against 1e-3 for a typical element;
observed relative gap 3e-4). The ring over ranks runs the same tile
calls in the same order as the local ring, and gloo moves the tensors
exactly, so its outputs and gradients hold to 1e-6; the SP transformer's
gradients, averaged over the ranks, to 1e-6 too (each rank's loss is its
shard's mean, summed in another order than the whole sequence's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu.models.transformer as jtfm
from horovod_tpu.exceptions import NotInitializedError as JaxNotInitialized
from horovod_tpu.ops.collectives import (
    exchange_bucket_plan as jax_bucket_plan)
from horovod_tpu.stats import CollectiveStats as JaxCollectiveStats
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel.ring_attention import RingAxis, ring_attention
from horovod_tpu_torch.stats import CollectiveStats
from torch_ranks import launch_ranks

RANKS = 2
LR, WD = 1e-3, 1e-4
SGD_LR = 0.1
ATOL = 1e-6
FP16_RTOL = 2e-3
ADAM_REL = 1e-3
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=16, n_kv_heads=2, positional="rope",
           attention_impl="flash", loss_chunk=8)
RING_WINDOW = 6
# (name, exchange_buckets, backward_passes_per_step, compression)
OPT_CASES = (("one-bucket", 1, 1, "none"), ("three-buckets", 3, 1, "none"),
             ("two-passes", 1, 2, "none"), ("fp16", 2, 1, "fp16"))

WORKER = r'''
import json
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tfm

torch.set_num_threads(1)
inp = np.load(sys.argv[1])
out_dir = sys.argv[2]
cfg_kw = json.loads(sys.argv[3])
opt_cases = json.loads(sys.argv[4])
res, text = {}, {}

hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
text["topology"] = [r, n, hvd.local_rank(), hvd.local_size()]

x = torch.from_numpy(inp["x"][r])
ints = torch.from_numpy(inp["ints"][r])
res["allreduce_avg"] = hvd.allreduce(x).numpy()
res["allreduce_sum"] = hvd.allreduce(x, average=False).numpy()
for i, t in enumerate(hvd.grouped_allreduce([x, ints, 2 * x],
                                            average=False)):
    res[f"grouped_{i}"] = t.numpy()
res["grouped_avg"] = hvd.grouped_allreduce([x])[0].numpy()
res["allgather"] = hvd.allgather(x).numpy()
res["broadcast"] = hvd.broadcast(x, root_rank=1).numpy()

lin = torch.nn.Linear(4, 3)
with torch.no_grad():
    lin.weight.fill_(r + 1.0)
    lin.bias.fill_(-r - 1.0)
hvd.broadcast_parameters(lin.state_dict(), root_rank=0)
res["bcast_params"] = torch.cat([p.detach().reshape(-1)
                                 for p in lin.parameters()]).numpy()
adam = torch.optim.AdamW(lin.parameters(), lr=0.1 * (r + 1))
lin(torch.full((2, 4), r + 1.0)).sum().backward()
adam.step()
hvd.broadcast_optimizer_state(adam, root_rank=0)
res["bcast_opt_exp_avg"] = adam.state[lin.weight]["exp_avg"].numpy()
text["bcast_opt_lr"] = adam.param_groups[0]["lr"]


def mlp():
    m = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                            torch.nn.Linear(5, 3))
    with torch.no_grad():
        for p, key in zip(m.parameters(), ("w0", "b0", "w1", "b1")):
            p.copy_(torch.from_numpy(inp[key]))
    return m


for name, buckets, passes, comp in opt_cases:
    m = mlp()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=float(inp["sgd_lr"])),
        named_parameters=m.named_parameters(), exchange_buckets=buckets,
        backward_passes_per_step=passes,
        compression=getattr(hvd.Compression, comp))
    text[f"buckets_{name}"] = [len(b) for b in opt.exchange_buckets]
    for step in range(2):
        opt.zero_grad()
        for mb in range(passes):
            xb = torch.from_numpy(inp["data_x"][step, mb, r])
            yb = torch.from_numpy(inp["data_y"][step, mb, r])
            ((m(xb) - yb) ** 2).mean().backward()
        opt.step()
    res[f"opt_{name}"] = torch.cat([p.detach().reshape(-1)
                                    for p in m.parameters()]).numpy()

cfg = tfm.TransformerConfig(dtype=torch.float32, **cfg_kw)
tree = {k[2:]: inp[k] for k in inp.files if k.startswith("p:")
        and "." not in k}
tree["layers"] = [{} for _ in range(cfg.n_layers)]
for k in inp.files:
    if k.startswith("p:layers."):
        _, i, leaf = k[2:].split(".")
        tree["layers"][int(i)][leaf] = inp[k]
lm = tfm.TransformerLM(cfg, tfm.params_from_jax(tree, cfg, device="cpu"),
                       device="cpu")
hvd.broadcast_parameters(lm.state_dict(), root_rank=0)
opt = hvd.DistributedOptimizer(
    torch.optim.AdamW(lm.parameters(), lr=float(inp["lr"]),
                      betas=(0.9, 0.999), eps=1e-8,
                      weight_decay=float(inp["wd"])),
    named_parameters=lm.named_parameters())
half = inp["tokens"].shape[0] // n
rows = slice(r * half, (r + 1) * half)
calls0 = hvd.runtime._state.stats.counter("allreduce")
for step in range(3):
    opt.zero_grad()
    lm.loss(torch.from_numpy(inp["tokens"][rows]),
            torch.from_numpy(inp["targets"][rows])).backward()
    opt.step()
    flat = tfm.params_to_numpy(lm.params)
    for k, v in flat.items():
        if k != "layers":
            res[f"e2e{step}:{k}"] = v
    for i, layer in enumerate(flat["layers"]):
        for k, v in layer.items():
            res[f"e2e{step}:layers.{i}.{k}"] = v
text["e2e_allreduce_calls"] = (
    hvd.runtime._state.stats.counter("allreduce") - calls0)

# Ring attention over the process group: this rank holds shard r.
from horovod_tpu_torch.parallel.ring_attention import RingAxis, ring_attention
axis = RingAxis.over()
text["ring_axis"] = [axis.size, list(axis.shards)]
s_loc = inp["ring_q"].shape[1] // n
sl = slice(r * s_loc, (r + 1) * s_loc)
qkv = [torch.from_numpy(inp[f"ring_{x}"][:, sl]).requires_grad_()
       for x in "qkv"]
out = ring_attention(*qkv, axis, impl="flash",
                     window=int(inp["ring_window"]))
grads = torch.autograd.grad(
    (out * torch.from_numpy(inp["ring_g"][:, sl])).sum(), qkv)
res["ring_out"] = out.detach().numpy()
for x, g in zip("qkv", grads):
    res[f"ring_d{x}"] = g.numpy()

# The SP transformer over the process group: half the sequence a rank.
import dataclasses
sp_cfg = dataclasses.replace(cfg, attention_window=int(inp["ring_window"]))
sp_lm = tfm.TransformerLM(sp_cfg, tfm.params_from_jax(tree, cfg,
                                                      device="cpu"),
                          device="cpu",
                          axes=tfm.ShardAxes(sp=RingAxis.over()))
t_loc = inp["tokens"].shape[1] // n
cols = slice(r * t_loc, (r + 1) * t_loc)
loss = sp_lm.loss(torch.from_numpy(inp["tokens"][:, cols]),
                  torch.from_numpy(inp["targets"][:, cols]))
loss.backward()
res["sp_loss"] = loss.detach().numpy()
for k, v in sp_lm.named_parameters():
    res[f"sp_grad:{k}"] = v.grad.numpy()
hvd.shutdown()
np.savez(f"{out_dir}/rank{r}.npz", **res)
with open(f"{out_dir}/rank{r}.json", "w") as f:
    json.dump(text, f)
'''


def _flat_tree(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return out


def _inputs():
    rng = np.random.default_rng(0)
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, flash_interpret=True,
                                  **CFG)
    params = tfm.params_to_numpy(tfm.init_params(
        tfm.TransformerConfig(dtype=torch.float32, **CFG),
        torch.Generator().manual_seed(0), "cpu"))
    tokens = rng.integers(0, CFG["vocab_size"], (4, CFG["max_seq"]))
    inp = {
        "x": rng.standard_normal((RANKS, 2, 3, 4)).astype(np.float32),
        "ints": rng.integers(-5, 5, (RANKS, 7)),
        "w0": rng.standard_normal((5, 6)).astype(np.float32),
        "b0": rng.standard_normal(5).astype(np.float32),
        "w1": rng.standard_normal((3, 5)).astype(np.float32),
        "b1": rng.standard_normal(3).astype(np.float32),
        "data_x": rng.standard_normal((2, 2, RANKS, 8, 6)).astype(np.float32),
        "data_y": rng.standard_normal((2, 2, RANKS, 8, 3)).astype(np.float32),
        "sgd_lr": np.float32(SGD_LR), "lr": np.float32(LR),
        "wd": np.float32(WD),
        "tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
        "ring_q": rng.standard_normal((1, 16, 4, 8)).astype(np.float32),
        "ring_k": rng.standard_normal((1, 16, 2, 8)).astype(np.float32),
        "ring_v": rng.standard_normal((1, 16, 2, 8)).astype(np.float32),
        "ring_g": rng.standard_normal((1, 16, 4, 8)).astype(np.float32),
        "ring_window": np.int64(RING_WINDOW),
    }
    inp.update({f"p:{k}": v for k, v in _flat_tree(params).items()})
    return inp, jcfg, params


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results: ({rank: arrays}, {rank: values}, inputs,
    jax config, jax params, profiler dump path)."""
    import json
    out = tmp_path_factory.mktemp("ranks")
    inp, jcfg, params = _inputs()
    np.savez(out / "inputs.npz", **inp)
    launch_ranks(RANKS, ["-c", WORKER, str(out / "inputs.npz"), str(out),
                         json.dumps(CFG), json.dumps(OPT_CASES)],
                 env={"HOROVOD_PROFILER_PATH": str(out / "profiler.txt"),
                      "HOROVOD_PROFILER_DISABLE": ""}, timeout=120)
    arrays = {r: dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)}
    values = {r: json.loads((out / f"rank{r}.json").read_text())
              for r in range(RANKS)}
    return arrays, values, inp, jcfg, params, out / "profiler.txt"


def test_ranks_are_processes(run):
    _, values, *_ = run
    assert [values[r]["topology"] for r in range(RANKS)] == [
        [r, RANKS, r, RANKS] for r in range(RANKS)]


def test_allreduce_average_and_sum(run):
    arrays, _, inp, *_ = run
    total = inp["x"].sum(axis=0)
    for r in range(RANKS):
        np.testing.assert_allclose(arrays[r]["allreduce_sum"], total,
                                   atol=ATOL)
        np.testing.assert_allclose(arrays[r]["allreduce_avg"], total / RANKS,
                                   atol=ATOL)


def test_grouped_allreduce_keeps_each_dtype(run):
    arrays, _, inp, *_ = run
    for r in range(RANKS):
        np.testing.assert_allclose(arrays[r]["grouped_0"],
                                   inp["x"].sum(axis=0), atol=ATOL)
        assert arrays[r]["grouped_1"].dtype == np.int64
        np.testing.assert_array_equal(arrays[r]["grouped_1"],
                                      inp["ints"].sum(axis=0))
        np.testing.assert_allclose(arrays[r]["grouped_2"],
                                   2 * inp["x"].sum(axis=0), atol=ATOL)
        np.testing.assert_allclose(arrays[r]["grouped_avg"],
                                   inp["x"].mean(axis=0), atol=ATOL)


def test_allgather_and_broadcast(run):
    arrays, _, inp, *_ = run
    for r in range(RANKS):
        np.testing.assert_array_equal(arrays[r]["allgather"],
                                      np.concatenate(list(inp["x"])))
        np.testing.assert_array_equal(arrays[r]["broadcast"], inp["x"][1])


def test_broadcast_parameters_and_optimizer_state(run):
    arrays, values, *_ = run
    want = np.concatenate([np.full(12, 1.0), np.full(3, -1.0)])
    for r in range(RANKS):
        np.testing.assert_array_equal(arrays[r]["bcast_params"], want)
        np.testing.assert_array_equal(arrays[r]["bcast_opt_exp_avg"],
                                      arrays[0]["bcast_opt_exp_avg"])
        assert values[r]["bcast_opt_lr"] == pytest.approx(0.1)


def _expected_sgd(inp, passes):
    """Two SGD steps on the mean over ranks of each rank's gradient
    summed over its ``passes`` backward passes."""
    m = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                            torch.nn.Linear(5, 3))
    with torch.no_grad():
        for p, key in zip(m.parameters(), ("w0", "b0", "w1", "b1")):
            p.copy_(torch.from_numpy(inp[key]))
    for step in range(2):
        total = [torch.zeros_like(p) for p in m.parameters()]
        for r in range(RANKS):
            for mb in range(passes):
                xb = torch.from_numpy(inp["data_x"][step, mb, r])
                yb = torch.from_numpy(inp["data_y"][step, mb, r])
                grads = torch.autograd.grad(((m(xb) - yb) ** 2).mean(),
                                            list(m.parameters()))
                total = [t + g for t, g in zip(total, grads)]
        with torch.no_grad():
            for p, g in zip(m.parameters(), total):
                p -= SGD_LR * g / RANKS
    return torch.cat([p.detach().reshape(-1)
                      for p in m.parameters()]).numpy()


@pytest.mark.parametrize("case", OPT_CASES, ids=[c[0] for c in OPT_CASES])
def test_distributed_optimizer_averages_gradients(run, case):
    arrays, values, inp, *_ = run
    name, buckets, passes, comp = case
    want = _expected_sgd(inp, passes)
    sizes = values[0][f"buckets_{name}"]
    assert len(sizes) == min(buckets, 4) and sum(sizes) == 4
    for r in range(RANKS):
        got = arrays[r][f"opt_{name}"]
        if comp == "fp16":
            np.testing.assert_allclose(got, want, rtol=FP16_RTOL, atol=1e-4)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL)


def _jax_reference(jcfg, params, inp):
    """Parameters after each of 3 steps of the JAX package's
    DistributedOptimizer(optax.adamw) in shard_map over 2 devices."""
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("hvd",))
    tx = jhvd.DistributedOptimizer(optax.adamw(LR, weight_decay=WD),
                                   axis_name="hvd")
    axes = jtfm.ShardAxes(dp="hvd", sp=None, tp=None)

    def shard_step(p, state, tokens, targets):
        g = jax.grad(lambda q: jtfm.loss_fn(q, tokens, targets, jcfg,
                                            axes))(p)
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    step = jax.jit(jax.shard_map(
        shard_step, mesh=mesh, in_specs=(P(), P(), P("hvd"), P("hvd")),
        out_specs=(P(), P()), check_vma=False))
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    out = []
    for _ in range(3):
        p, state = step(p, state, jnp.asarray(inp["tokens"]),
                        jnp.asarray(inp["targets"]))
        out.append(_flat_tree(jax.tree.map(np.asarray, p)))
    return out


def test_two_ranks_track_the_jax_distributed_optimizer(run):
    arrays, values, inp, jcfg, params, _ = run
    want = _jax_reference(jcfg, params, inp)
    for r in range(RANKS):
        # One fused all-reduce of every gradient per step (one bucket).
        assert values[r]["e2e_allreduce_calls"] == 3
        for step, tree in enumerate(want):
            for k, v in tree.items():
                moved = np.linalg.norm(v - inp[f"p:{k}"])
                err = np.linalg.norm(arrays[r][f"e2e{step}:{k}"] - v)
                assert err <= ADAM_REL * moved, (r, step, k, err / moved)


def test_ring_over_ranks_matches_the_local_ring(run):
    """Ring attention over 2 gloo ranks (flash tiles, window 6 over
    shards of 8: the second step's band tile) against the local ring of
    2 on the whole sequence."""
    arrays, values, inp, *_ = run
    qkv = [torch.from_numpy(inp[f"ring_{x}"]).requires_grad_() for x in "qkv"]
    out = ring_attention(*qkv, RingAxis.local(RANKS), impl="flash",
                         window=RING_WINDOW)
    grads = torch.autograd.grad((out * torch.from_numpy(inp["ring_g"])).sum(),
                                qkv)
    want = {"ring_out": out.detach().numpy()}
    want.update({f"ring_d{x}": g.numpy() for x, g in zip("qkv", grads)})
    s_loc = out.shape[1] // RANKS
    for r in range(RANKS):
        assert values[r]["ring_axis"] == [RANKS, [r]]
        for name, w in want.items():
            np.testing.assert_allclose(
                arrays[r][name], w[:, r * s_loc:(r + 1) * s_loc], atol=ATOL,
                rtol=0, err_msg=f"rank {r} {name}")


def test_sp_transformer_over_ranks_matches_the_local_ring(run):
    """Each rank's loss is the mean over all tokens, and the ranks'
    gradients average to the local ring's: what DistributedOptimizer's
    world average takes."""
    arrays, _, inp, _, params, _ = run
    cfg = tfm.TransformerConfig(dtype=torch.float32, **dict(
        CFG, attention_window=RING_WINDOW))
    lm = tfm.TransformerLM(cfg, tfm.params_from_jax(params, cfg, "cpu"),
                           device="cpu",
                           axes=tfm.ShardAxes(sp=RingAxis.local(RANKS)))
    loss = lm.loss(torch.from_numpy(inp["tokens"]),
                   torch.from_numpy(inp["targets"]))
    loss.backward()
    for r in range(RANKS):
        np.testing.assert_allclose(arrays[r]["sp_loss"], loss.item(),
                                   atol=ATOL, rtol=0)
    for k, v in lm.named_parameters():
        mean = sum(arrays[r][f"sp_grad:{k}"] for r in range(RANKS)) / RANKS
        np.testing.assert_allclose(mean, v.grad.numpy(), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_profiler_dump_written_by_rank_zero(run):
    *_, dump = run
    text = dump.read_text().splitlines()
    assert text[0].startswith("Counter allreduce,")
    assert int(text[0].split(",")[1]) > 0
    assert "Counter broadcast,0" not in text


@pytest.mark.parametrize("sizes,buckets", [
    ([4, 4, 4, 4], 2), ([100, 1, 1, 1, 100], 3), ([8], 4), ([], 2),
    ([1, 2, 3, 4, 5, 6, 7, 8], 1), ([64, 32, 16, 8, 4], 8),
])
def test_exchange_bucket_plan_matches_jax(sizes, buckets):
    leaves = [np.zeros(n, np.float32) for n in sizes]
    assert hvd.exchange_bucket_plan(
        [torch.from_numpy(x) for x in leaves], buckets) == \
        jax_bucket_plan(leaves, buckets)


def test_profiler_layout_matches_jax(tmp_path):
    records = [("allreduce", 1024, 0.0015), ("allreduce", 1024, 0.0005),
               ("allreduce", 8, 2e-6), ("broadcast", 64, 0.25),
               ("allgather", 12, 0.0)]
    port, ref = CollectiveStats(), JaxCollectiveStats()
    for op, nbytes, secs in records:
        port.record(op, nbytes, secs)
        ref.record(op, nbytes, secs)
    port.write_to_file(str(tmp_path / "port.txt"))
    ref.write_to_file(str(tmp_path / "ref.txt"))
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "ref.txt").read_text()
    # The host-clock timer records one call of its size, as the JAX one.
    with port.timer("gather", 16), ref.timer("gather", 16):
        pass
    assert [sz for sz in port.histogram("gather")] == [16]
    assert port.counter("gather") == ref.counter("gather") == 1


def test_use_before_init_error_text():
    assert not hvd.is_initialized()
    with pytest.raises(hvd.NotInitializedError) as err:
        hvd.size()
    assert str(err.value) == str(JaxNotInitialized())


def test_one_rank_session_restarts_and_checks_its_arguments(monkeypatch,
                                                            tmp_path):
    monkeypatch.delenv("HOROVOD_TPU_COORDINATOR", raising=False)
    monkeypatch.setenv("HOROVOD_PROFILER_DISABLE", "")
    monkeypatch.setenv("HOROVOD_PROFILER_PATH", str(tmp_path / "prof.txt"))
    lin = torch.nn.Linear(3, 2)
    for _ in range(2):
        hvd.init(device="cpu")
        try:
            assert (hvd.rank(), hvd.size()) == (0, 1)
            assert hvd.mesh().mesh_dim_names == ("hvd",)
            with pytest.raises(ValueError, match="unique"):
                hvd.DistributedOptimizer(
                    torch.optim.SGD(lin.parameters(), lr=0.1),
                    named_parameters=[("w", lin.weight), ("w", lin.bias)])
            with pytest.raises(ValueError, match="zero_stage must be 0..3"):
                hvd.DistributedOptimizer(
                    torch.optim.SGD(lin.parameters(), lr=0.1), zero_stage=4)
            with pytest.raises(NotImplementedError,
                               match="dcn_compression='int8'"):
                hvd.DistributedOptimizer(
                    torch.optim.SGD(lin.parameters(), lr=0.1),
                    compression=hvd.Compression.int8)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(lin.parameters(), lr=0.1))
            lin(torch.ones(1, 3)).sum().backward()
            with pytest.raises(AssertionError, match="backward_passes_per_"
                                                     "step"):
                lin(torch.ones(1, 3)).sum().backward()
            opt.step()
        finally:
            hvd.shutdown()
    # Each session dumps its own counters: one exchange of one bucket.
    assert "Counter allreduce,1\n" in (tmp_path / "prof.txt").read_text()
    with pytest.raises(hvd.ShutDownError):
        hvd.allreduce(torch.ones(2))


def test_deleted_optimizer_and_model_are_freed(monkeypatch):
    """The gradient hooks hold the optimizer weakly: once the caller drops
    the model and its DistributedOptimizer, a collection frees both, with
    their gradients and state. (Hooks bound to the optimizer made a cycle
    through each parameter's hook table that the collector never freed.)"""
    import gc
    import weakref
    monkeypatch.delenv("HOROVOD_TPU_COORDINATOR", raising=False)
    hvd.init(device="cpu")
    try:
        lin = torch.nn.Linear(4, 3)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(lin.parameters()),
                                       named_parameters=lin.named_parameters())
        lin(torch.ones(2, 4)).sum().backward()
        opt.step()
        refs = [weakref.ref(lin.weight), weakref.ref(opt)]
        del lin, opt
        gc.collect()
        assert [r() for r in refs] == [None, None]
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("knob,value,item", [
    ("HOROVOD_TIMELINE", "/tmp/t.json", "item 10"),
    ("HOROVOD_GUARD", "1", "item 15"),
    ("HOROVOD_AUTOTUNE", "1", "item 10"),
])
def test_init_refuses_knobs_of_missing_subsystems(monkeypatch, knob, value,
                                                  item):
    monkeypatch.setenv(knob, value)
    with pytest.raises(NotImplementedError, match=item):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
    with pytest.raises(NotImplementedError, match="item 2"):
        hvd.init(comm=[0])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()
