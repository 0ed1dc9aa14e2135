"""The port's ZeRO ladder and DCN-staged exchange (horovod_tpu_torch/
optimizers.py, ops/collectives.py) over 4 gloo ranks, against the JAX
package.

One run of 4 processes (tests/torch_ranks.py, the cases in
tests/torch_rank_workers.py ``zero``) trains tests/test_zero_sharding.py's
6 -> 13 -> 3 MLP with torch Adam/SGD at 1e-2 under each layout; the
reference runs ``optax.adam``/``optax.sgd`` under the JAX package's
``DistributedOptimizer`` inside ``shard_map`` over 4 of the conftest's
virtual CPU devices, each rank's 4 rows of the same batch on its device.
The MLP's parameters register in the reference's leaf order (b1, b2, w1,
w2), so the flat row, its stripes and chunks are the reference's element
for element. The bands are the reference test's own: 2e-5 between
layouts over 10 Adam steps, 1e-6 between chunkings, rtol 1e-6 for the
uncompressed staged exchange, 0.02 relative for a compressed hop, 0.15
and 5% for compressed training.

The port gathers the stripe's parameters where the JAX package gathers
the stripe's update and adds it: with an elementwise optimizer the two
are the same values up to rounding (within the 2e-5 of the layout
bands); across a compressed DCN hop the port, too, sends the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops.compression import Int8Compressor as JaxInt8
from horovod_tpu.optimizers import _zero1 as jax_zero1
from horovod_tpu.optimizers import _zero_sharded as jax_zero_sharded
import horovod_tpu_torch as hvd
from horovod_tpu_torch import metrics
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.compression import Compression, Int8Compressor
from torch_ranks import spawn_ranks
import torch_rank_workers

AXIS = "hvd"
N = 4
LEAVES = ("b1", "b2", "w1", "w2")
TOTAL = 6 * 13 + 13 + 13 * 3 + 3


def _make_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(6, 13).astype(np.float32) * 0.3,
            "b1": np.zeros((13,), np.float32),
            "w2": rng.randn(13, 3).astype(np.float32) * 0.3,
            "b2": np.zeros((3,), np.float32)}


def _make_batch(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(N * 4, 6).astype(np.float32),
            rng.randn(N * 4, 3).astype(np.float32))


@pytest.fixture(scope="module")
def run():
    x, y = _make_batch()
    inp = {"params": _make_params(), "x": x, "y": y,
           "rows": np.random.RandomState(2).randn(N, N * 6)
           .astype(np.float32),
           "crows": np.random.RandomState(3).randn(N, N * 4)
           .astype(np.float32)}
    return inp, spawn_ranks(N, torch_rank_workers.zero, inp)


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), (AXIS,))


def _loss_fn(params, x, y):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] + params["b2"] - y) ** 2)


def _jax_host(tx, steps=10):
    """tests/test_zero_sharding.py's ``_run_host`` over 4 devices."""
    mesh = _mesh()
    params = {k: jnp.asarray(v) for k, v in _make_params().items()}
    x, y = (jnp.asarray(a) for a in _make_batch())

    def shard_body(params, opt_state, x, y):
        g = jax.grad(_loss_fn)(params, x, y)
        upd, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, upd), opt_state

    step = jax.jit(jax.shard_map(
        shard_body, mesh=mesh, in_specs=(P(), P(), P(AXIS), P(AXIS)),
        out_specs=P(), check_vma=False))
    opt_state = jax.jit(jax.shard_map(
        tx.init, mesh=mesh, in_specs=(P(),), out_specs=P(),
        check_vma=False))(params)
    for _ in range(steps):
        params, opt_state = step(params, opt_state, x, y)
    return {k: np.asarray(v) for k, v in params.items()}


_JAX = {}


def _jax_ref(name, make):
    if name not in _JAX:
        _JAX[name] = _jax_host(make())
    return _JAX[name]


def _jax_adam(**kw):
    return _jax_ref(f"adam{sorted(kw.items())}",
                    lambda: jhvd.DistributedOptimizer(optax.adam(1e-2), **kw))


def _max_abs_diff(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in LEAVES)


def _every_rank(res, name):
    """The parameters ``name`` of rank 0, after checking that every rank
    holds the same bits (the gather gives each rank the whole row)."""
    for r in range(1, N):
        for k in LEAVES:
            assert np.array_equal(res[r][name][k], res[0][name][k]), (r, k)
    return res[0][name]


# ------------------------------------------------------------ equivalence


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_host_path_matches_the_jax_package(run, stage):
    """Eager zero1/2/3 (zero3 standalone behaves as zero2) against the
    JAX package's same stage and against the port's stage 0."""
    _, res = run
    got = _every_rank(res, f"zero{stage}")
    assert res[0][f"mode:zero{stage}"] == f"zero{stage}"
    assert _max_abs_diff(got, _jax_adam(zero_stage=stage)) < 2e-5
    assert _max_abs_diff(got, _every_rank(res, "zero0")) < 2e-5
    assert _max_abs_diff(_every_rank(res, "zero0"), _jax_adam()) < 2e-5
    moved = _max_abs_diff(got, _make_params())
    assert moved > 1e-2


def test_reduce_scatter_is_zero1_and_zero1_is_the_unchunked_ladder(run):
    """``reduce_scatter=True`` is zero1. The port runs zero1 as the
    unchunked ``_zero_sharded``: the JAX package's legacy ``_zero1`` and
    its ``_zero_sharded(zero_stage=1)`` give the same bits, and the port
    lies within the layout band of both."""
    _, res = run
    z1 = _every_rank(res, "zero1")
    assert res[0]["mode:reduce_scatter"] == "zero1"
    for k in LEAVES:
        assert np.array_equal(_every_rank(res, "reduce_scatter")[k], z1[k])
    legacy = _jax_ref("zero1_legacy", lambda: jax_zero1(
        optax.adam(1e-2), AXIS, True, jhvd.Compression.none))
    general = _jax_ref("zero1_general", lambda: jax_zero_sharded(
        optax.adam(1e-2), AXIS, True, jhvd.Compression.none, 1))
    for k in LEAVES:
        assert np.array_equal(legacy[k], general[k]), k
    assert _max_abs_diff(z1, legacy) < 2e-5


def test_zero2_bucketed_matches(run):
    """``bucket_bytes=64`` cuts the row into 9 chunks of 16 elements: a
    re-bracketing of the scatter, which changes no sum."""
    _, res = run
    assert _max_abs_diff(_every_rank(res, "zero2_b64"),
                         _every_rank(res, "zero2")) < 1e-6
    assert _max_abs_diff(_every_rank(res, "zero2_b64"),
                         _jax_adam(zero_stage=2, bucket_bytes=64)) < 2e-5


@pytest.mark.parametrize("case,base", [("c_zero2", "adam"),
                                       ("c_zero3_adam", "adam"),
                                       ("c_zero3_sgd", "sgd")])
def test_zero_compiled_roundtrip_matches(run, case, base):
    """``compiled_train_step``: zero2, and zero3's ``shard_params`` -> 10
    steps -> ``unshard_params``, against the replicated trajectory (the
    port's compiled stage 0 and the JAX package's psum) of the same base
    optimizer."""
    _, res = run
    got = _every_rank(res, case)
    ref = _every_rank(res, "c_zero0" if base == "adam" else "c_zero0_sgd")
    assert _max_abs_diff(got, ref) < 2e-5
    jax_ref = (_jax_adam() if base == "adam" else _jax_ref(
        "sgd", lambda: jhvd.DistributedOptimizer(optax.sgd(1e-2))))
    assert _max_abs_diff(got, jax_ref) < 2e-5


def test_zero3_stripe_memory_is_one_over_n(run):
    """The zero3 stripe is ceil(total / n) long, Adam's state over it
    shards the same way, the gauges read the stripe, and the full-width
    round trip is exact."""
    _, res = run
    shard = -(-TOTAL // N)
    for out in res:
        assert out["stripe_len"] == shard
        assert out["adam_state_shapes"] == [(), (shard,), (shard,)]
        assert out["roundtrip_exact"]
        gauges = out["stripe_gauges"]
        assert gauges['kind="grads"'] == gauges['kind="params"'] == shard * 4
        assert gauges['kind="opt"'] == 2 * shard * 4 + 4


def test_the_flat_row_is_the_references_element_for_element(run):
    """Each rank's zero3 stripe is its segment of the JAX package's flat
    row (``jax.tree.leaves`` order, zero-padded to a multiple of n);
    under staging (local 2) rank r holds segment ``dcn_sigma(r)``."""
    _, res = run
    row = np.concatenate([np.asarray(v).reshape(-1) for v in
                          jax.tree.leaves(_make_params())])
    shard = -(-TOTAL // N)
    row = np.concatenate([row, np.zeros(shard * N - TOTAL, np.float32)])
    for r, out in enumerate(res):
        assert np.array_equal(out["stripe"], row[r * shard:(r + 1) * shard])
        sig = out["sigma2"]
        assert np.array_equal(out["staged_stripe"],
                              row[sig * shard:(sig + 1) * shard])


# --------------------------------------------------- DCN staged exchange


@pytest.mark.parametrize("local", [1, 2, 4])
def test_dcn_staged_uncompressed_is_exact(run, local):
    """Two-stage scatter -> gather reassembles the exact global sum for
    every ICI group size (the owner permutation round-trips)."""
    inp, res = run
    for out in res:
        assert out[f"staged_res{local}"] is None
        np.testing.assert_allclose(out[f"staged{local}"],
                                   inp["rows"].sum(0), rtol=1e-6)


def _jax_staged(rows, comp, local):
    mesh = _mesh()

    def body(x):
        x = x[0]
        res0 = jnp.zeros((x.shape[0] // local,), x.dtype)
        stripe, res = jcoll.dcn_staged_psum_scatter(
            x, AXIS, local=local, dcn_compression=comp, residual=res0)
        full = jcoll.dcn_staged_all_gather(stripe, AXIS, local=local,
                                           dcn_compression=comp)
        return full[None], res[None], stripe[None]

    return [np.asarray(a) for a in jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(AXIS),),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)), check_vma=False))(
            jnp.asarray(rows))]


@pytest.mark.parametrize("comp", ["bf16", "int8"])
def test_dcn_compressed_close_and_residual_carries(run, comp):
    """A compressed DCN hop (local 2: 2 hosts of 2 ranks): within 0.02 of
    the exact sum, with a nonzero residual below 0.1; and, on the same
    inputs, the JAX package's stripe, residual and gather."""
    inp, res = run
    want = inp["crows"].sum(0)
    jfull, jres, jstripe = _jax_staged(inp["crows"], comp, 2)
    for r, out in enumerate(res):
        err = np.abs(out[f"full_{comp}"] - want).max() / np.abs(want).max()
        assert err < 0.02, err
        assert 0.0 < np.abs(out[f"res_{comp}"]).max() < 0.1
        np.testing.assert_allclose(out[f"stripe_{comp}"], jstripe[r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out[f"res_{comp}"], jres[r], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(out[f"full_{comp}"], jfull[r], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("comp", ["bf16", "int8"])
def test_dcn_compressed_training_converges(run, comp):
    """12 compiled zero2 steps with a compressed DCN hop (local 2) land
    within 0.15 of the uncompressed parameters, the final loss within
    5%."""
    _, res = run
    got, ref = _every_rank(res, f"c12_{comp}"), _every_rank(res, "c12")
    assert _max_abs_diff(got, ref) < 0.15
    for out in res:
        a, b = out[f"loss:c12_{comp}"][-1], out["loss:c12"][-1]
        assert abs(a - b) < 0.05 * max(abs(b), 1e-3)


def test_dcn_residual_state_lives_in_optimizer_state(run):
    """The residual travels in ``state_dict()`` (and loads back), padded
    / local long, zero before the first step; an uncompressed run
    carries none."""
    _, res = run
    padded = -(-TOTAL // N) * N
    for out in res:
        assert out["residual:int8"].shape == (padded // 2,)
        assert np.abs(out["residual:int8"]).max() == 0.0
        assert out["state_residual:int8"] and out["state_residual:plain"]
        assert out["residual:plain"] is None
        # the state's form, as the reference names it: zero1 with a
        # residual, zero1 without (reduce_scatter=True's), stage 0 staged
        assert out["state_kinds"] == ["ZeroShardState", "Zero1State",
                                      "DcnExchangeState"]
        assert np.abs(out["residual_after_step"]).max() > 0.0
        assert np.array_equal(out["residual_loaded"],
                              out["residual_after_step"])


def test_broadcast_optimizer_state_keeps_each_ranks_stripe(run):
    """Each rank's Adam state covers its own stripe: the broadcast leaves
    it (only 0-d tensors and scalars travel)."""
    _, res = run
    assert all(out["stripe_state_kept"] for out in res)
    assert not np.array_equal(res[0]["exp_avg"], res[1]["exp_avg"])


def test_dcn_sigma_permutation(run):
    """sigma(r) = (r % L) * H + r // L, a permutation of the ranks, as the
    JAX package's ``dcn_sigma`` gives it on 4 devices."""
    _, res = run
    mesh = _mesh()
    for local in (1, 2, 4):
        jax_sig = np.asarray(jax.jit(jax.shard_map(
            lambda _: jnp.asarray([jcoll.dcn_sigma(AXIS, local)]),
            mesh=mesh, in_specs=(P(AXIS),), out_specs=P(AXIS),
            check_vma=False))(jnp.zeros((N,), jnp.int32)))
        got = [out[f"sigma{local}"] for out in res]
        assert got == [int(s) for s in jax_sig]
        assert sorted(got) == list(range(N))
    assert [out["sigma2"] for out in res] == [0, 2, 1, 3]


def test_zero2_with_a_half_wire_stays_close(run):
    """``compression=Compression.fp16`` on the stripe's scatter (the
    chunk compressed, summed in fp16, restored): within the 0.05 the
    reference allows a 16-bit wire at stage 0."""
    _, res = run
    assert res[0]["mode:zero2_fp16"] == "zero2"
    delta = _max_abs_diff(_every_rank(res, "zero2_fp16"),
                          _every_rank(res, "zero2"))
    assert 0.0 < delta < 0.05


def test_zero0_dcn_exchange_chains_with_any_optimizer(run):
    """``dcn_compression`` at stage 0: the staged exchange (mode
    "inline") in front of the unsharded optimizer, within 0.05 of the
    plain exchange."""
    _, res = run
    assert res[0]["mode:dcn0_bf16"] == "inline"
    assert _max_abs_diff(_every_rank(res, "dcn0_bf16"),
                         _every_rank(res, "zero0")) < 0.05


def test_zero_metrics_families(run):
    """Two compiled zero2 steps with an int8 DCN hop: the ICI stage at
    full width, the DCN stage compressed by more than 40% (int8 scatter,
    bf16 update gather), the stage gauge at 2, and one reduce-scatter
    and one all-gather record a tier a step."""
    _, res = run
    for out in res:
        (w_ici, w_dcn), (r_ici, r_dcn) = out["wire"], out["raw"]
        assert w_ici == r_ici > 0
        assert 1.0 - w_dcn / r_dcn >= 0.4
        assert out["zero_stage_gauge"] == 2.0
        chunk = -(-TOTAL // N) * N // 2
        assert out["jit"] == {("reducescatter_jit", 4 * 2 * chunk): 2,
                              ("reducescatter_jit", chunk): 2,
                              ("allgather_jit", chunk): 2,
                              ("allgather_jit", 4 * chunk): 2}
    names = {"hvd_zero_stage", "hvd_zero_stripe_bytes",
             "hvd_wire_stage_bytes_total", "hvd_wire_stage_raw_bytes_total",
             "hvd_wire_stage_seconds", "hvd_spec_leaves"}
    snap = metrics.snapshot()
    assert names <= set(snap)
    from horovod_tpu import metrics as jax_metrics
    for name in names:
        assert snap[name]["help"] == \
            jax_metrics.snapshot()[name]["help"], name


# ----------------------------------------------------- one-process cases


def test_int8_codes_match_the_reference_including_halves():
    """``scale_for``/``quantize`` against the JAX package's: round half to
    even on exact halves, the clip at 127, and ``compress`` on a random
    f32 tensor (codes and scale equal)."""
    halves = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 300.0, -300.0],
                      np.float32)
    got = Int8Compressor.quantize(torch.from_numpy(halves), torch.tensor(1.0))
    want = JaxInt8.quantize(jnp.asarray(halves), jnp.float32(1.0))
    assert got.tolist() == [0, 2, 2, -0, -2, 126, 127, -127]
    assert np.array_equal(got.numpy(), np.asarray(want))
    x = np.random.default_rng(4).standard_normal(257).astype(np.float32)
    codes, (dtype, scale) = Int8Compressor.compress(torch.from_numpy(x))
    jcodes, (_, jscale) = JaxInt8.compress(jnp.asarray(x))
    assert codes.dtype == torch.int8 and dtype == torch.float32
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert float(scale) == float(jscale)
    back = Int8Compressor.decompress(codes, (dtype, scale))
    assert np.array_equal(back.numpy(), np.asarray(
        JaxInt8.decompress(jcodes, (jnp.float32, jscale))))
    zero = Int8Compressor.scale_for(torch.tensor(0.0))
    assert float(zero) == float(JaxInt8.scale_for(jnp.float32(0.0)))
    assert Compression.int8 is Int8Compressor
    assert Int8Compressor.wire_dtype(torch.float32) == torch.int8
    assert Int8Compressor.wire_dtype(torch.int32) == torch.int32


def _init():
    if not hvd.is_initialized():
        hvd.init(device="cpu")


@pytest.fixture
def one_rank(monkeypatch):
    monkeypatch.delenv("HOROVOD_TPU_COORDINATOR", raising=False)
    _init()
    yield
    hvd.shutdown()


def _sgd():
    return torch.optim.SGD(torch.nn.Linear(3, 2).parameters(), lr=1e-2)


def _jax_error(**kw):
    with pytest.raises(ValueError) as err:
        jhvd.DistributedOptimizer(optax.sgd(1e-2), **kw)
    return str(err.value)


@pytest.mark.parametrize("kw", [
    {"zero_stage": 5},
    {"zero_stage": 2, "dcn_compression": "lz4"},
    {"zero_stage": 2, "dcn_compression": object()},
    {"zero_stage": 2, "dcn_compression": "int8",
     "compression": "fp16"}])
def test_zero_stage_conflicts_rejected(one_rank, kw):
    """The reference's conflicts, word for word."""
    if kw.get("compression") == "fp16":
        want = _jax_error(**dict(kw, compression=jhvd.Compression.fp16))
        kw = dict(kw, compression=Compression.fp16)
    else:
        want = _jax_error(**kw)
    with pytest.raises(ValueError) as got:
        hvd.DistributedOptimizer(_sgd(), **kw)
    assert str(got.value) == want


def test_unported_and_unsafe_arguments_raise(one_rank):
    """``model_keys`` on a runtime without a model mesh raise (no layout
    drops the model axis: tests/test_torch_step_program.py holds the
    words to the reference's); ``compression=Compression.int8``
    (per-rank scales around a plain sum) is refused, pointing at the
    reference's docstring; param groups with different hyperparameters
    cannot share one flat stripe."""
    with pytest.raises(ValueError, match="HOROVOD_MODEL_PARALLEL"):
        hvd.DistributedOptimizer(_sgd(), zero_stage=2, model_keys=("w",))
    with pytest.raises(NotImplementedError, match="compression.py:100"):
        hvd.DistributedOptimizer(_sgd(), compression=Compression.int8)
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD([{"params": [lin.weight], "lr": 0.1},
                           {"params": [lin.bias], "lr": 0.2}])
    with pytest.raises(ValueError, match="same hyperparameters"):
        hvd.DistributedOptimizer(opt, named_parameters=lin.named_parameters(),
                                 zero_stage=1)
    # every spelling the reference takes for the two compressed wires
    from horovod_tpu.optimizers import _normalize_dcn_compression as want
    from horovod_tpu_torch.optimizers import _normalize_dcn_compression
    for v, jv in (("BF16", "BF16"), ("8bit", "8bit"), ("off", "off"),
                  (None, None), (Compression.int8, jhvd.Compression.int8),
                  (Compression.bf16, jhvd.Compression.bf16),
                  (Compression.none, jhvd.Compression.none)):
        assert _normalize_dcn_compression(v) == want(jv)


def test_one_rank_ladder_is_stage_zero_bitwise(one_rank):
    """At one rank the scatter and gather are copies and the average is
    by 1: every stage's AdamW trajectory is stage 0's, bit for bit, and
    staging is off (no residual, no sub-group)."""
    def train(**kw):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(6, 13), torch.nn.Tanh(),
                                    torch.nn.Linear(13, 3))
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters(), **kw)
        x, y = torch.randn(8, 6), torch.randn(8, 3)
        for _ in range(4):
            opt.zero_grad()
            ((model(x) - y) ** 2).mean().backward()
            opt.step()
        return [p.detach() for p in model.parameters()], opt

    ref, _ = train()
    for kw in ({"zero_stage": 1}, {"zero_stage": 2, "bucket_bytes": 64},
               {"zero_stage": 3}, {"dcn_compression": "int8"},
               {"zero_stage": 2, "dcn_compression": "bf16"}):
        got, opt = train(**kw)
        assert all(torch.equal(a, b) for a, b in zip(ref, got)), kw
        assert opt.state_dict()["dcn_residual"] is None
    assert hvd.runtime.live_state().groups == {}


def test_transformer_tree_leaves_give_the_references_flat_row(one_rank):
    """``tfm.tree_leaves`` orders a transformer's parameters as
    ``jax.tree.leaves`` does its ``params_to_numpy`` tree (the MoE
    layer's nested dict included), so a ZeRO optimizer over them holds
    the reference's flat row: at one rank the stripe is the whole row."""
    from horovod_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                n_kv_heads=2, n_layers=2, d_ff=64,
                                max_seq=16, dtype=torch.float32,
                                moe_layers=(1,), moe_num_experts=4)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(tfm.tree_leaves(lm.params)), zero_stage=1)
    want = np.concatenate([np.asarray(v).reshape(-1) for v in
                           jax.tree.leaves(tfm.params_to_numpy(lm.params))])
    assert np.array_equal(opt.stripe.detach().numpy(), want)


def test_config_reads_the_zero_knobs_with_the_references_clamps(monkeypatch):
    from horovod_tpu.config import Config as JaxConfig
    from horovod_tpu_torch.config import Config
    for bucket, local, comp in (("64", "2", "int8"), ("0", "-3", ""),
                                ("", "x", "bf16")):
        monkeypatch.setenv("HOROVOD_REDUCE_SCATTER_BUCKET", bucket)
        monkeypatch.setenv("HOROVOD_DCN_LOCAL_SIZE", local)
        monkeypatch.setenv("HOROVOD_DCN_COMPRESSION", comp)
        got, want = Config.from_env(), JaxConfig.from_env()
        assert (got.reduce_scatter_bucket, got.dcn_local_size,
                got.dcn_compression) == (want.reduce_scatter_bucket,
                                         want.dcn_local_size,
                                         want.dcn_compression)


@pytest.mark.parametrize("n,local", [(8, 0), (8, 2), (8, 3), (8, 16),
                                     (4, 4), (6, -1)])
def test_dcn_layout_helpers_match_the_reference(monkeypatch, n, local):
    monkeypatch.delenv("HOROVOD_DCN_LOCAL_SIZE", raising=False)
    assert collectives.normalize_dcn_local_size(n, local or n) == \
        jcoll.normalize_dcn_local_size(n, local or n)
    eff = jcoll.normalize_dcn_local_size(n, local or n)
    assert collectives.dcn_index_groups(n, eff) == \
        jcoll.dcn_index_groups(n, eff)
