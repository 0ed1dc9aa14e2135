"""The port's per-leaf sharding spec (horovod_tpu_torch/optimizers.py
``_ShardingSpec``) over 4 gloo ranks laid out as 2 data x 2 expert
(``HOROVOD_EXPERT_PARALLEL=2``), against the JAX package.

The combos of tests/test_sharding_spec.py that need no model axis, in
one run of 4 processes (tests/torch_ranks.py, the cases in
tests/torch_rank_workers.py ``sharding_spec``):

- the 1-D ladder's exchanges (psum, zero1-3) spelled as a spec compile
  to the same bits as their direct forms (tests/test_torch_zero.py's MLP,
  5 steps);
- the moe fast path, the expert exchange in the gradient hooks, equals
  the same layout spelled as a pure expert spec, bit for bit;
- expert keys x zero2, and x zero2 x a bf16 DCN hop, train within the
  reference's 1e-7 over 10 SGD steps of their components (the moe fast
  path; the expert spec with the DCN hop at stage 0; zero2 over the
  world with every expert on each rank), and of the JAX package's same
  combination on a 2 x 2 mesh of virtual CPU devices; with Adam,
  striping stays within the reference's 1e-6 of stage 0.

As in the reference's combo test, ``dcn_local_size=2`` equals the data
axis, so staging is off there (the reference's own test runs so); a
staged hop over the data axis (local 1: each data rank its own host)
is held to the uncompressed combo within the compressed-training band of
tests/test_zero_sharding.py (0.15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models import moe as jax_moe
from torch_ranks import spawn_ranks
import torch_rank_workers

EP, DATA = 2, 2
N = EP * DATA
CFG = dict(d_model=16, d_ff=32, num_experts=4, top_k=2, capacity_factor=4.0)
STEPS, LR = 10, 0.05
COMBO_ATOL = 1e-7  # tests/test_sharding_spec.py's band for the combos


def _mlp_inputs():
    rng = np.random.RandomState(0)
    params = {"w1": rng.randn(6, 13).astype(np.float32) * 0.3,
              "b1": np.zeros((13,), np.float32),
              "w2": rng.randn(13, 3).astype(np.float32) * 0.3,
              "b2": np.zeros((3,), np.float32)}
    rng = np.random.RandomState(1)
    return params, rng.randn(N * 4, 6).astype(np.float32), \
        rng.randn(N * 4, 3).astype(np.float32)


@pytest.fixture(scope="module")
def run():
    params, x, y = _mlp_inputs()
    rng = np.random.default_rng(8)
    d, ff, e = CFG["d_model"], CFG["d_ff"], CFG["num_experts"]
    inp = {"params": params, "x": x, "y": y,
           "w_router": rng.standard_normal((d, e), np.float32) / d ** 0.5,
           "w1": rng.standard_normal((e, d, ff), np.float32) / d ** 0.5,
           "w2": rng.standard_normal((e, ff, d), np.float32) / ff ** 0.5,
           "mx": rng.standard_normal((N, 2, 8, d), np.float32),
           "my": rng.standard_normal((N, 2, 8, d), np.float32)}
    res = spawn_ranks(N, torch_rank_workers.sharding_spec, inp, CFG, STEPS,
                      LR, env={"HOROVOD_EXPERT_PARALLEL": str(EP)})
    return inp, res


def _max_delta(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


# ------------------------------------------- legacy tags re-expressed

@pytest.mark.parametrize("name,mode", [("psum", "hooks"), ("zero1", "zero1"),
                                       ("zero2", "zero2"),
                                       ("zero3", "zero3")])
def test_ladder_as_spec_bitwise(run, name, mode):
    """Each legacy exchange and the same layout as a spec (mode "spec")
    over 5 compiled steps: the same bits (zero3 read back through
    ``unshard_params``)."""
    _, res = run
    for out in res:
        assert out[f"mode:{name}:direct"] == mode
        assert out[f"mode:{name}:spec"] == "spec"
        for a, b in zip(out[f"{name}:direct"], out[f"{name}:spec"]):
            assert np.array_equal(a, b)


def test_moe_fast_path_is_the_expert_spec_bitwise(run):
    """The moe fast path (mode "moe", the hooks' expert exchange) and the
    same layout spelled as a pure expert spec (mode "spec") land on the
    same collectives: the same bits."""
    _, res = run
    for out in res:
        assert (out["mode:moe"], out["mode:moe_spec"]) == ("moe", "spec")
        for k in out["moe"]:
            assert np.array_equal(out["moe"][k], out["moe_spec"][k]), k


# ---------------------------------------- the combinations, against JAX

def _jax_moe_steps(inp, tx, steps):
    """The JAX package's transform ``tx`` on a 2 x 2 (hvd, ep) mesh of
    virtual CPU devices (device (i, j) holds rank i*2 + j's tokens, the
    experts sharded over ep), init and update inside ``shard_map``;
    returns each rank's parameters."""
    jcfg = jax_moe.MoEConfig(dtype=jnp.float32, **CFG)
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(DATA, EP),
                ("hvd", "ep"))
    specs = jax_moe.moe_specs("ep")
    rows = P(("hvd", "ep"))

    def shard_step(p, state, x, y):
        def loss(q):
            out, aux = jax_moe.moe_layer(q, x[0], jcfg, ep_axis="ep")
            return jnp.mean((out - y[0]) ** 2) + 0.01 * aux
        g = jax.grad(loss)(p)
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    p = {k: jnp.asarray(inp[k]) for k in ("w_router", "w1", "w2")}
    state = jax.jit(jax.shard_map(tx.init, mesh=mesh, in_specs=(specs,),
                                  out_specs=P(), check_vma=False))(p)
    step = jax.jit(jax.shard_map(
        shard_step, mesh=mesh, in_specs=(specs, P(), rows, rows),
        out_specs=(specs, P()), check_vma=False))
    for _ in range(steps):
        p, state = step(p, state, jnp.asarray(inp["mx"]),
                        jnp.asarray(inp["my"]))
    e_loc = CFG["num_experts"] // EP
    return [{k: np.asarray(v) if k == "w_router"
             else np.asarray(v)[(r % EP) * e_loc:(r % EP + 1) * e_loc]
             for k, v in p.items()} for r in range(N)]


@pytest.mark.parametrize("case,kw", [
    ("moe_zero2", {"zero_stage": 2}),
    ("moe_zero2_dcn", {"zero_stage": 2, "dcn_compression": "bf16",
                       "dcn_local_size": 2})])
def test_moe_zero2_combos_match_the_jax_package(run, case, kw):
    inp, res = run
    want = _jax_moe_steps(inp, jhvd.DistributedOptimizer(
        optax.sgd(LR), expert_keys=("w1", "w2"), **kw), STEPS)
    for r, out in enumerate(res):
        assert out[f"mode:{case}"] == "spec"
        assert _max_delta(out[case], want[r]) <= COMBO_ATOL, r


def test_moe_zero2_combo_parity_vs_components(run):
    """expert keys x zero2 against the pure expert exchange within the
    reference's 1e-7 (the stripe adds no rounding: the sums are the
    same, only split), and expert keys x zero2 x DCN against expert keys
    x DCN at stage 0, whose spec carries the DCN link."""
    inp, res = run
    for out in res:
        assert _max_delta(out["moe_zero2"], out["moe"]) <= COMBO_ATOL
        assert _max_delta(out["moe_zero2_dcn"], out["moe_dcn"]) \
            <= COMBO_ATOL
        assert out["spec:moe_dcn"] == (("hvd", "ep"), True)
        assert out["spec:moe_zero2_dcn"] == (("hvd", "ep"), False)
        assert np.abs(out["moe"]["w1"] - inp["w1"][
            (out["rank"] % EP) * 2:(out["rank"] % EP + 1) * 2]).max() > 1e-4
    # the data group keeps both data rows' experts equal
    for r in range(EP):
        for k in ("w1", "w2"):
            assert np.array_equal(res[r]["moe_zero2"][k],
                                  res[r + EP]["moe_zero2"][k])
    assert res[0]["spec_leaves"] == {'kind="dense"': 1.0,
                                     'kind="expert"': 2.0,
                                     'kind="model"': 0.0}


def test_moe_zero2_dcn_stateful_optimizer(run):
    """Adam under expert keys x a DCN link: striping at stage 2 stays
    within the reference's 1e-6 of stage 0 from the same init."""
    _, res = run
    for out in res:
        assert _max_delta(out["adam_zero2_dcn"], out["adam_zero0_dcn"]) \
            <= 1e-6


def test_moe_zero2_staged_dcn_hop_converges(run):
    """A staged bf16 hop over the data axis (local 1) in the combo:
    within the compressed-training band of the uncompressed combo."""
    _, res = run
    for out in res:
        assert out["spec:moe_zero2_staged"] == (("hvd", "ep"), False)
        delta = _max_delta(out["moe_zero2_staged"], out["moe_zero2"])
        assert 0.0 < delta < 0.15


def test_zero2_combo_matches_data_parallel_zero2(run):
    """The combo's experts, gathered over the expert group, against
    zero2 over the world with every expert on each rank (the
    reference's third component)."""
    _, res = run
    e_loc = CFG["num_experts"] // EP
    for r in range(N):
        group = [res[(r // EP) * EP + j]["moe_zero2"] for j in range(EP)]
        full = {k: np.concatenate([g[k] for g in group]) for k in
                ("w1", "w2")}
        full["w_router"] = res[r]["moe_zero2"]["w_router"]
        assert _max_delta(full, res[r]["zero2_only"]) <= COMBO_ATOL
        assert full["w1"].shape[0] == EP * e_loc
