"""The port's MoE layer (horovod_tpu_torch/models/moe.py) against the JAX
package's (horovod_tpu/models/moe.py), on the CPU.

The same inputs, made with numpy, go through ``horovod_tpu.models.moe.
moe_layer`` (eager) and the port's ``moe_layer``, at d 64, ff 128, E 4,
top-2, with ample capacity (nothing drops), a tight one (drops) and full
capacity, in f32 and bf16. The routing — which (token, slot) lands in
which expert slot and which drop — must be identical: the port's index
tables rebuilt as dense tensors equal the JAX ``_top_k_dispatch``'s on
the JAX probabilities, and the port's own dense plain version on the
port's. The routed and dropped counts are equal.

Tolerances: f32 outputs and aux to 2e-5 and gradients to 5e-5, the
reference's own bands for its kernels against dense math
(tests/test_flash_attention.py:22, :52); both sides compute in f32 and
differ in summation order only. A bf16 output is the sum of two gate-
weighted expert rows rounded to bf16, each row rounded to bf16 first: a
row whose f32 value straddles a rounding boundary moves by one bf16 ulp
(2^-8 of it) on one side only, so bf16 outputs hold to 2^-7 of the
largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import moe as jax_moe
from horovod_tpu_torch.models import moe

F32_ATOL = 2e-5
GRAD_ATOL = 5e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# capacity factor, full capacity: (ample: nothing drops), (drops), full
CAPACITY = {"ample": (4.0, False), "drops": (0.5, False),
            "full": (1.25, True)}


def _cfgs(dtype="float32", **kw):
    kw.setdefault("d_model", 64)
    kw.setdefault("d_ff", 128)
    kw.setdefault("num_experts", 4)
    kw.setdefault("top_k", 2)
    kw.setdefault("capacity_factor", 1.25)
    td, jd = DTYPES[dtype]
    return (moe.MoEConfig(dtype=td, **kw),
            jax_moe.MoEConfig(dtype=jd, **kw))


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"w_router": rng.standard_normal((d, e), np.float32) / d ** 0.5,
            "w1": rng.standard_normal((e, d, ff), np.float32) / d ** 0.5,
            "w2": rng.standard_normal((e, ff, d), np.float32) / ff ** 0.5}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _torch(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def _jax_probs(params, x, dtype):
    """The JAX layer's router probabilities for ``x`` cast to ``dtype``."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(dtype)
    xf = xf.astype(jnp.float32)
    return jax.nn.softmax(xf @ jnp.asarray(params["w_router"]), axis=-1)


@pytest.mark.parametrize("cap", list(CAPACITY))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_layer_matches_jax(dtype, cap):
    """Output, aux, stats and the drop pattern against the JAX layer."""
    cf, full = CAPACITY[cap]
    cfg, jcfg = _cfgs(dtype, capacity_factor=cf)
    params = _params(cfg)
    x = _x((2, 24, cfg.d_model))
    td, jd = DTYPES[dtype]
    want_y, want_aux, want_st = jax_moe.moe_layer(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x).astype(jd), jcfg, with_stats=True,
        full_capacity=full)
    y, aux, st = moe.moe_layer(_torch(params), torch.from_numpy(x).to(td),
                               cfg, with_stats=True, full_capacity=full)
    assert y.dtype == td and y.shape == x.shape
    want_y = np.asarray(want_y.astype(jnp.float32))
    atol = F32_ATOL if dtype == "float32" else \
        2.0 ** -7 * np.abs(want_y).max()
    np.testing.assert_allclose(y.float().numpy(), want_y, atol=atol, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=F32_ATOL,
                               rtol=0)
    for key in ("routed_tokens", "dropped_tokens"):
        assert st[key].item() == float(want_st[key]), key
    assert st["chunks"] == want_st["chunks"] == 1
    dropped = float(want_st["dropped_tokens"])
    assert (dropped > 0) == (cap == "drops")
    # The drop pattern: the port's tables against the JAX dispatch.
    t = x.shape[0] * x.shape[1]
    c = moe.capacity(t, cfg, full)
    want_d, want_c = jax_moe._top_k_dispatch(_jax_probs(params, x, jd),
                                             cfg.top_k, c)
    xf = torch.from_numpy(x).to(td).reshape(t, -1)
    r = moe._route(moe._router(xf, _torch(params)["w_router"]), cfg.top_k, c)
    got_d, got_c = moe.routing_to_dense(r, c)
    assert np.array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("cap", list(CAPACITY))
def test_index_tables_equal_the_dense_plain_version(cap):
    """The tables rebuilt as dense tensors equal ``_top_k_dispatch``'s,
    bit for bit, on the same probabilities; each kept slot's token is
    the token the dense dispatch puts there, and every empty slot points
    at the zero row (token t)."""
    cf, full = CAPACITY[cap]
    cfg, _ = _cfgs(capacity_factor=cf)
    t = 48
    probs = torch.softmax(torch.from_numpy(_x((t, 4), seed=3)) * 2, -1)
    c = moe.capacity(t, cfg, full)
    r = moe._route(probs, cfg.top_k, c)
    want_d, want_c = moe._top_k_dispatch(probs, cfg.top_k, c)
    got_d, got_c = moe.routing_to_dense(r, c)
    assert torch.equal(got_d, want_d) and torch.equal(got_c, want_c)
    occupied = want_d.sum(0) > 0                              # (E, C)
    owner = torch.argmax(want_d, dim=0)                       # (E, C)
    assert torch.equal(r.slot_token[occupied], owner[occupied])
    assert (r.slot_token[~occupied] == t).all()
    assert r.kept.sum().item() == want_d.sum().item()


def test_top_k_breaks_ties_toward_the_lower_index():
    """``lax.top_k``'s rule: equal values in index order. A uniform row,
    and rows with a tie below the top pick."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.3, 0.3, 0.3],
                          [0.4, 0.2, 0.2, 0.2],
                          [0.2, 0.2, 0.4, 0.2]])
    vals, idx = moe._top_k(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(want_i).tolist() == [
        [0, 1], [1, 2], [0, 1], [2, 0]]
    assert np.array_equal(vals.numpy(), np.asarray(want_v))


def test_index_form_equals_the_plain_version():
    """``moe_layer`` against ``moe_layer_reference`` (the dense einsums)
    with drops: the same routing, the same expert rows, the combine in
    another order of two terms; f32."""
    cfg, _ = _cfgs(capacity_factor=0.5)
    p = _torch(_params(cfg))
    x = torch.from_numpy(_x((2, 24, cfg.d_model)))
    y, aux, st = moe.moe_layer(p, x, cfg, with_stats=True)
    y_ref, aux_ref, st_ref = moe.moe_layer_reference(p, x, cfg,
                                                     with_stats=True)
    torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=0)
    assert aux.item() == aux_ref.item()
    assert st["routed_tokens"].item() == st_ref["routed_tokens"].item()
    assert st["dropped_tokens"].item() == st_ref["dropped_tokens"].item()


@pytest.mark.parametrize("cap", ["ample", "drops"])
def test_gradients_match_jax_grad(cap):
    """d/d(params, x) of sum(y * g) + 0.01 aux against ``jax.grad``,
    f32."""
    cf, full = CAPACITY[cap]
    cfg, jcfg = _cfgs(capacity_factor=cf)
    params = _params(cfg)
    x = _x((2, 24, cfg.d_model))
    g = _x(x.shape, seed=2)

    def jloss(p, xs):
        y, aux = jax_moe.moe_layer(p, xs, jcfg, full_capacity=full)
        return jnp.sum(y * jnp.asarray(g)) + 0.01 * aux

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _torch(params).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_layer(tp, tx, cfg, full_capacity=full)
    loss = (y * torch.from_numpy(g)).sum() + 0.01 * aux
    loss.backward()
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want_p[k]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x),
                               atol=GRAD_ATOL, rtol=0)


# Ports of tests/test_moe.py's single-device cases (d 16, ff 32, f32).

def _small(**kw):
    kw.setdefault("d_model", 16)
    kw.setdefault("d_ff", 32)
    kw.setdefault("num_experts", 4)
    kw.setdefault("top_k", 2)
    kw.setdefault("capacity_factor", 2.0)
    return moe.MoEConfig(dtype=torch.float32, **kw)


def _small_params(cfg):
    return moe.init_moe_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_single_expert_equals_plain_ffn():
    """E=1, k=1, ample capacity: MoE == that expert's FFN exactly (gate
    renormalizes to 1)."""
    cfg = _small(num_experts=1, top_k=1, capacity_factor=4.0)
    params = _small_params(cfg)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y, aux = moe.moe_layer(params, x, cfg)
    h = torch.nn.functional.gelu(x @ params["w1"][0], approximate="tanh")
    torch.testing.assert_close(y, h @ params["w2"][0], atol=1e-5, rtol=0)
    assert aux.item() == pytest.approx(1.0, abs=1e-5)


def test_capacity_drops_tokens():
    """Tiny capacity: dropped tokens produce zero output (the residual
    carries them in a full block)."""
    cfg = _small(num_experts=2, top_k=1, capacity_factor=0.01)
    params = _small_params(cfg)
    x = torch.randn(1, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y, _ = moe.moe_layer(params, x, cfg)
    # capacity = max(1, ceil(16*1*0.01/2)) = 1 slot per expert -> at most
    # 2 tokens routed, at least 14 rows must be exactly zero
    assert int((y[0] == 0).all(dim=-1).sum()) >= 14


def test_top2_routing_mixes_two_experts():
    cfg = _small(num_experts=4, top_k=2, capacity_factor=4.0)
    params = {k: v.requires_grad_() for k, v in _small_params(cfg).items()}
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y, aux = moe.moe_layer(params, x, cfg)
    assert torch.isfinite(y).all() and aux.item() > 0
    ((y ** 2).sum() + 0.01 * aux).backward()
    for k in ("w_router", "w1", "w2"):
        assert torch.isfinite(params[k].grad).all()
        assert params[k].grad.abs().sum().item() > 0, k


def test_load_balance_loss_uniform_router():
    """Zero router weights -> uniform probs -> with ample capacity the
    Switch aux loss is exactly top_k (E * sum_e frac_e * 1/E and the
    routed fractions sum to top_k)."""
    cfg = _small(num_experts=4, top_k=2, capacity_factor=8.0)
    params = _small_params(cfg)
    params["w_router"] = torch.zeros_like(params["w_router"])
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    _, aux, stats = moe.moe_layer(params, x, cfg, with_stats=True)
    assert aux.item() == pytest.approx(cfg.top_k, abs=1e-5)
    assert stats["dropped_tokens"].item() == 0.0
    assert stats["routed_tokens"].item() == 16 * cfg.top_k


def test_rejects_an_expert_slice_that_does_not_tile_the_experts():
    cfg = _small()
    params = moe.expert_slice(_small_params(cfg), 0, 2)
    with pytest.raises(ValueError, match="expert shards"):
        moe.moe_layer(params, torch.zeros(1, 4, cfg.d_model), cfg)


# Expert parallelism over 4 gloo ranks: 2 data x 2 expert, E 4 (two
# experts a rank), one run of tests/torch_ranks.py's spawn_ranks.

EP, DATA = 2, 2
EP_CFG = dict(d_model=16, d_ff=32, num_experts=4, top_k=2,
              capacity_factor=2.0)
EP_STEPS, EP_LR = 3, 0.05


@pytest.fixture(scope="module")
def ep_run():
    from torch_ranks import spawn_ranks
    import torch_rank_workers
    cfg = moe.MoEConfig(dtype=torch.float32, **EP_CFG)
    rng = np.random.default_rng(7)
    inp = dict(_params(cfg, seed=8))
    inp["x"] = rng.standard_normal((EP * DATA, 2, 8, 16), np.float32)
    inp["target"] = rng.standard_normal((EP * DATA, 2, 8, 16), np.float32)
    res = spawn_ranks(EP * DATA, torch_rank_workers.expert_parallel, inp,
                      EP_CFG, EP_STEPS, EP_LR,
                      env={"HOROVOD_EXPERT_PARALLEL": str(EP)})
    return inp, res


def test_expert_parallel_layer_matches_local(ep_run):
    """Each rank's tokens through its expert group equal the same tokens
    through every expert locally (tests/test_moe.py:85's bands), and
    chunks 3 (falling back to 2) and 4 equal chunks 1 bit for bit."""
    _, res = ep_run
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["y_ep1"], out["y_local"], rtol=2e-4,
                                   atol=2e-5, err_msg=f"rank {r}")
        for chunks in (3, 4):
            assert np.array_equal(out[f"y_ep{chunks}"], out["y_ep1"])
        assert [out[f"chunks_used{c}"] for c in (1, 3, 4)] == [1, 2, 4]


def _jax_ep_steps(inp):
    """The JAX package's step on a 2 x 2 (hvd, ep) mesh of virtual CPU
    devices: ``hvd.DistributedOptimizer(optax.sgd, expert_keys=("w1",
    "w2"))``'s per-axis exchange inside ``shard_map``, the experts
    sharded over ``ep`` (device (i, j) holds rank i*2 + j's tokens)."""
    import optax
    from jax.sharding import Mesh, PartitionSpec as P
    import horovod_tpu as jhvd
    jcfg = jax_moe.MoEConfig(dtype=jnp.float32, **EP_CFG)
    mesh = Mesh(np.array(jax.devices()[:EP * DATA]).reshape(DATA, EP),
                ("hvd", "ep"))
    tx = jhvd.DistributedOptimizer(optax.sgd(EP_LR),
                                   expert_keys=("w1", "w2"))
    specs = jax_moe.moe_specs("ep")
    rows = P(("hvd", "ep"))

    def shard_step(p, state, x, y):
        def loss(q):
            out, aux = jax_moe.moe_layer(q, x[0], jcfg, ep_axis="ep",
                                         chunks=2)
            return jnp.mean((out - y[0]) ** 2) + 0.01 * aux
        g = jax.grad(loss)(p)
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    step = jax.jit(jax.shard_map(
        shard_step, mesh=mesh, in_specs=(specs, P(), rows, rows),
        out_specs=(specs, P()), check_vma=False))
    p = {k: jnp.asarray(inp[k]) for k in ("w_router", "w1", "w2")}
    state = tx.init(p)
    out = []
    for _ in range(EP_STEPS):
        p, state = step(p, state, jnp.asarray(inp["x"]),
                        jnp.asarray(inp["target"]))
        out.append({k: np.asarray(v) for k, v in p.items()})
    return out


def test_expert_parallel_sgd_matches_the_jax_2d_mesh_step(ep_run):
    """Parameters after each of 3 SGD steps: each rank's expert slice and
    router against the JAX step's, f32 (atol 1e-5: gradients within
    5e-5 times lr 0.05, three times); the compiled step bitwise equal to
    the eager one, in exchange mode "moe"."""
    inp, res = ep_run
    want = _jax_ep_steps(inp)
    e_loc = EP_CFG["num_experts"] // EP
    for r, out in enumerate(res):
        sl = slice((r % EP) * e_loc, (r % EP + 1) * e_loc)
        assert out["exchange_mode"] == "moe"
        for i, tree in enumerate(want):
            for k, v in tree.items():
                w = v if k == "w_router" else v[sl]
                got = out[f"eager{i}:{k}"]
                np.testing.assert_allclose(got, w, atol=1e-5, rtol=0,
                                           err_msg=f"rank {r} step {i} {k}")
                assert np.array_equal(out[f"compiled{i}:{k}"], got), (r, i, k)
        moved = np.abs(out[f"eager{EP_STEPS - 1}:w1"] - inp["w1"][sl]).max()
        assert moved > 1e-4
    # the data group's all-reduce keeps both data rows' experts equal
    for r in range(EP):
        assert np.array_equal(res[r][f"eager{EP_STEPS - 1}:w1"],
                              res[r + EP][f"eager{EP_STEPS - 1}:w1"])
