"""Tensor parallelism on the 3-D (data, expert, model) mesh: the port
(horovod_tpu_torch) against the JAX package, on the CPU.

The same numpy inputs (the reference's own ``init_params`` trees, its
random tokens) go through the JAX package, in ``shard_map`` over the
conftest's virtual XLA devices, and through the port's ranks, processes
joined by gloo (tests/torch_ranks.py; what each rank runs is in
tests/torch_rank_workers.py). One run of 2 ranks (a model group,
``HOROVOD_MODEL_PARALLEL=2``) covers the mesh, the sharded trunk,
decoding and serving; one run of 8 ranks the 2 x 2 x 2 combination.

Tolerances are the reference's own:
- losses: ``rtol`` 2e-4, and gradients ``atol`` 5e-4, ``rtol`` 5e-3
  (tests/test_models.py:103, :126);
- the TP serve engine against the unsharded one and against the
  reference's engine over a mesh of 2: argmax equal, f32 ``atol`` 3e-4
  (tests/test_serving.py:490); generated tokens equal;
- ZeRO-2 against ZeRO-0 on the 3-D mesh: 5e-7
  (tests/test_sharding_spec.py:355).

The gradients are per shard, before any exchange. The reference's trunk
runs under ``check_vma=False``, where the transpose of ``lax.psum`` is a
psum: a sharded leaf's per-shard gradient is tp times its block of the
unsharded gradient, and a replicated leaf's per-shard gradients sum over
the group to tp times the unsharded one. The port's ``_psum`` keeps that
convention, and the optimizer's sharding spec reduces it as the
reference's does (model leaves averaged over the other axes only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from jax.tree_util import keystr, tree_flatten_with_path

import horovod_tpu as jhvd
import horovod_tpu.models.transformer as jtfm
from horovod_tpu import config as jconfig
from horovod_tpu.optimizers import _ShardingSpec as JSpec
from horovod_tpu.parallel.mesh import model_expert_data_mesh as jax_mesh3d
from horovod_tpu_torch import config
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.optimizers import _ShardingSpec
from horovod_tpu_torch.parallel.mesh import model_expert_data_mesh
from torch_ranks import spawn_ranks
import torch_rank_workers

TP = 2
LOSS_RTOL = 2e-4
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3
SERVE_ATOL = 3e-4
COMBO_ATOL = 5e-7
BASE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64)


def _cfgs(**kw):
    """The (JAX, port) configurations of the same f32 model."""
    kw = {**BASE, **kw}
    jkw = {k: v for k, v in kw.items() if k != "attention_impl"
           or v == "dense"}
    return (jtfm.TransformerConfig(dtype=jnp.float32, **jkw),
            tfm.TransformerConfig(dtype=torch.float32, **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _case(seed=0, batch=(4, 32), **kw):
    jcfg, cfg = _cfgs(**kw)
    tree = _np(jtfm.init_params(jax.random.PRNGKey(seed), jcfg))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), batch, 0,
                                           jcfg.vocab_size))
    return jcfg, {"cfg": cfg, "tree": tree,
                  "batch": (tokens, np.roll(tokens, -1, axis=1))}


def _path_name(path):
    """A JAX ``keystr`` path in the port's dotted names:
    ``['layers'][0]['wqkv']`` -> ``layers.0.wqkv``."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


GRAD_CASES = {
    "mha": {},
    "gqa_rope": {"n_kv_heads": 2, "positional": "rope"},
    "chunked": {"loss_chunk": 8},
    "moe": {"moe_layers": (1,), "moe_num_experts": 4},
}
GEN_CASES = {"mha": None, "gqa": 2}


@pytest.fixture(scope="module")
def run():
    grads = {name: _case(**kw) for name, kw in GRAD_CASES.items()}
    ring_j, ring = _case(positional="rope")
    gens = {}
    for name, kv in GEN_CASES.items():
        jcfg, case = _case(n_kv_heads=kv, max_seq=16)
        case["prompt"] = np.asarray(jax.random.randint(
            jax.random.PRNGKey(1), (2, 6), 0, 64))
        gens[name] = (jcfg, case)
    serve_j, serve = _case(n_heads=8, max_seq=16, positional="rope",
                           attention_impl="flash")
    serve["tokens"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (2, 8), 0, 64))
    serve["prompts"] = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3]]
    _, convert = _case(n_kv_heads=2, positional="learned",
                       moe_layers=(1,))
    inp = {"grads": {k: v[1] for k, v in grads.items()}, "ring": ring,
           "generate": {k: v[1] for k, v in gens.items()}, "serve": serve,
           "convert": convert}
    res = spawn_ranks(TP, torch_rank_workers.tensor_parallel, inp,
                      env={"HOROVOD_MODEL_PARALLEL": str(TP)})
    return {"grads": grads, "ring": (ring_j, ring), "generate": gens,
            "serve": (serve_j, serve)}, res


# ----------------------------------------------------------- the mesh


def test_model_mesh_layout_and_runtime(run):
    """``HOROVOD_MODEL_PARALLEL=2`` over 2 ranks: the 3-D mesh with its
    expert axis at size 1, the reference's layout (model axis fastest),
    ``model_parallel_size()`` and the ``hvd_model_parallel`` gauge."""
    _, res = run
    want = jax_mesh3d(jax.devices()[:2], expert_parallel=1, model_parallel=2)
    for got in res:
        assert got["names"] == want.axis_names == ("hvd", "ep", "model")
        assert got["mesh"] == [[[d.id for d in row] for row in plane]
                               for plane in want.devices]
        assert got["mp"] == 2
        assert got["gauge"] == {"": 2.0}


@pytest.mark.parametrize("n,ep,mp,names", [
    (6, 2, 2, ("hvd", "ep", "model")),
    (8, 0, 2, ("hvd", "ep", "model")),
    (8, 2, -1, ("hvd", "ep", "model")),
    (8, 2, 2, ("hvd", "ep", "ep")),
])
def test_model_mesh_errors_match_the_reference(n, ep, mp, names):
    with pytest.raises(ValueError) as want:
        jax_mesh3d(jax.devices()[:1] * n, expert_parallel=ep,
                   model_parallel=mp, data_axis=names[0],
                   expert_axis=names[1], model_axis=names[2])
    with pytest.raises(ValueError) as got:
        model_expert_data_mesh("cpu", n, expert_parallel=ep,
                               model_parallel=mp, data_axis=names[0],
                               expert_axis=names[1], model_axis=names[2])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value", ["4", "0", "", "x"])
def test_model_parallel_knob_matches_the_reference(monkeypatch, value):
    monkeypatch.setenv("HOROVOD_MODEL_PARALLEL", value)
    assert config.Config.from_env().model_parallel == \
        jconfig.Config.from_env().model_parallel


# ------------------------------------------------- specs, keys, shards


SPEC_CFGS = {
    "mha": dict(BASE),
    "gqa": dict(BASE, n_kv_heads=2, positional="rope"),
    "moe": dict(BASE, moe_layers=(1,), moe_num_experts=4),
}


@pytest.mark.parametrize("name", sorted(SPEC_CFGS))
def test_param_specs_and_keys_match_keystr(name):
    """``param_specs`` entry for entry and ``model_parallel_keys`` one
    for one against the reference's ``keystr`` paths: full paths, none
    inside an MoE layer, and no key a substring of another leaf's name
    (a bare ``wq`` would take ``wqkv``)."""
    jcfg, cfg = _cfgs(**SPEC_CFGS[name])
    axes = jtfm.ShardAxes(dp=None, sp=None, tp="model", ep="ep")
    want = {_path_name(path): tuple(spec) for path, spec in
            tree_flatten_with_path(jtfm.param_specs(jcfg, axes),
                                   is_leaf=lambda x: isinstance(x, P))[0]}
    got = dict(tfm._named_leaves(tfm.param_specs(cfg)))
    assert got == want
    jkeys = jtfm.model_parallel_keys(jcfg, axes)
    keys = tfm.model_parallel_keys(cfg)
    flat = tree_flatten_with_path(jtfm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))[0]
    by_str = {keystr(p): _path_name(p) for p, _ in flat}
    assert [by_str[k] for k in jkeys] == list(keys)
    assert keys and all(".moe." not in k for k in keys)
    names = [n for n, _ in tfm._named_leaves(tfm.param_specs(cfg))]
    for k in keys:
        assert [n for n in names if k in n] == [k]


@pytest.mark.parametrize("name", sorted(SPEC_CFGS))
def test_slice_param_shards_match_the_reference(name):
    """Each rank's shard of the converter's tree (``params_from_jax``,
    then ``slice_param_shards`` at its coordinates) against the
    reference's per-device slices on the 2 x 2 x 2 mesh."""
    jcfg, cfg = _cfgs(**SPEC_CFGS[name])
    mesh = jax_mesh3d(jax.devices(), expert_parallel=2, model_parallel=2)
    axes = jtfm.ShardAxes(dp=None, sp=None, tp="model", ep="ep")
    full = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    sliced = jtfm.slice_param_shards(full, jtfm.param_specs(jcfg, axes),
                                     mesh)
    params = tfm.params_from_jax(_np(full), cfg, "cpu")
    for dev in range(8):
        coords = {"hvd": (dev // 4, 2), "ep": ((dev // 2) % 2, 2),
                  "model": (dev % 2, 2)}
        mine = dict(tfm._named_leaves(tfm.slice_param_shards(
            params, tfm.param_specs(cfg), coords)))
        for path, leaf in tree_flatten_with_path(sliced)[0]:
            block = next(s.data for s in leaf.addressable_shards
                         if s.device == jax.devices()[dev])
            np.testing.assert_array_equal(mine[_path_name(path)].numpy(),
                                          np.asarray(block))


def test_converter_shards_gather_back_to_the_tree(run):
    """``params_from_jax`` + ``slice_param_shards`` on each rank, its
    model-axis blocks all-gathered over the group: the full tree, bit
    for bit (GQA, learned positions, an MoE layer)."""
    _, res = run
    assert [got["roundtrip"] for got in res] == [0.0, 0.0]


# ------------------------------------------------------ the trunk


def _per_shard(jcfg, case):
    """The reference's loss and per-shard gradients at tp 2 inside
    ``shard_map(check_vma=False)``: each leaf stacked over the shards."""
    mesh = Mesh(np.array(jax.devices()[:TP]), ("tp",))
    axes = jtfm.ShardAxes(dp=None, sp=None, tp="tp")
    specs = jtfm.param_specs(jcfg, axes)

    def body(p, t, y):
        loss, g = jax.value_and_grad(
            lambda p: jtfm.loss_fn(p, t, y, jcfg, axes))(p)
        return loss[None], jax.tree.map(lambda a: a[None], g)

    stacked = jax.tree.map(lambda _: P("tp"), specs,
                           is_leaf=lambda x: isinstance(x, P))
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(specs, P(), P()),
                              out_specs=(P("tp"), stacked),
                              check_vma=False))
    loss, grads = f(case["tree"], *case["batch"])
    return np.asarray(loss), {_path_name(p): np.asarray(g) for p, g in
                              tree_flatten_with_path(grads)[0]}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_tp2_loss_and_per_shard_grads_match_the_reference(run, name):
    """tests/test_models.py:86, :106 at tp 2: each rank's loss and its
    gradient of every leaf before any exchange, against the reference's
    shard on the same device index (MHA, GQA with rope, the chunked
    cross entropy, an MoE layer replicated over the group)."""
    inp, res = run
    jcfg, case = inp["grads"][name]
    loss, grads = _per_shard(jcfg, case)
    for r, got in enumerate(res):
        got_loss, got_grads = got[f"grads:{name}"]
        np.testing.assert_allclose(got_loss, loss[r], rtol=LOSS_RTOL)
        assert set(got_grads) == set(grads)
        for k, g in got_grads.items():
            np.testing.assert_allclose(g, grads[k][r], atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_per_shard_grads_are_tp_times_the_unsharded_blocks(run, name):
    """The psum-transposes-to-psum convention, pinned: a sharded leaf's
    per-shard gradient is tp times its block of the unsharded gradient,
    and a replicated leaf's sum over the group is tp times the unsharded
    one (the losses are equal)."""
    inp, res = run
    _, cfg = _cfgs(**GRAD_CASES[name])
    specs = dict(tfm._named_leaves(tfm.param_specs(cfg)))
    ref_loss, ref = res[0][f"unsharded:{name}"]
    for k, whole in ref.items():
        spec = specs[k]
        shards = [got[f"grads:{name}"][1][k] for got in res]
        if "model" in spec:
            got = np.concatenate(shards, axis=spec.index("model")) / TP
        else:
            got = sum(shards) / TP
        np.testing.assert_allclose(got, whole, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)
    for got in res:
        np.testing.assert_allclose(got[f"grads:{name}"][0], ref_loss,
                                   rtol=LOSS_RTOL)


def test_tp_composes_with_a_local_ring(run):
    """tests/test_models.py:517: rope under tp 2 and a local ring of 2
    against the reference's unsharded loss and its dp x sp x tp run on
    the 2 x 2 x 2 virtual mesh."""
    inp, res = run
    jcfg, case = inp["ring"]
    tokens, targets = case["batch"]
    ref = float(jtfm.loss_fn(case["tree"], tokens, targets, jcfg))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("dp", "sp", "tp"))
    axes = jtfm.ShardAxes("dp", "sp", "tp")
    specs = jtfm.param_specs(jcfg, axes)
    f = jax.jit(jax.shard_map(
        lambda p, t, y: jtfm.loss_fn(p, t, y, jcfg, axes), mesh=mesh,
        in_specs=(specs, P("dp", "sp"), P("dp", "sp")), out_specs=P(),
        check_vma=False))
    sharded = float(f(case["tree"], tokens, targets))
    for got in res:
        np.testing.assert_allclose(got["ring"], ref, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["ring"], sharded, rtol=LOSS_RTOL)


# -------------------------------------------------- decoding, serving


@pytest.mark.parametrize("name", sorted(GEN_CASES))
def test_generate_tp2_matches_the_reference(run, name):
    """tests/test_models.py:736, :758: the greedy continuation at tp 2
    equals the reference's unsharded one; each rank's cache holds its 2
    kv heads (of 4), or its 1 (of 2) under GQA, and decode_step's logits
    are gathered to the full vocabulary."""
    inp, res = run
    jcfg, case = inp["generate"][name]
    want = np.asarray(jtfm.generate(case["tree"], case["prompt"], jcfg, 6))
    h_kv = (GEN_CASES[name] or 4) // TP
    for got in res:
        np.testing.assert_array_equal(got[f"generate:{name}"], want)
        assert got[f"cache:{name}"] == ((2, 8, h_kv, 8), (2, 64))


def _jax_tp_engine(jcfg, case, **kw):
    """The reference's engine over a mesh of 2 virtual devices, tensor
    parallel on its ``model`` axis, with the port's tree."""
    from horovod_tpu.serve.engine import ServeEngine as JaxServeEngine
    mesh = Mesh(np.array(jax.devices()[:TP]), ("model",))
    return JaxServeEngine(jax.tree.map(jnp.asarray, case["tree"]), jcfg,
                          mesh=mesh, tp_axis="model", **kw)


def test_tp_serve_engine_matches_the_unsharded_engine(run):
    """tests/test_serving.py:470-490: the engine over the model group
    (heads and the KV pool split on the kv-head dim) against the
    unsharded engine and against the reference's engine over a mesh of
    2, teacher-forced on the same tokens: argmax equal, logits within
    f32 ``atol`` 3e-4; each rank's pools hold 4 of the 8 kv heads."""
    inp, res = run
    jcfg, case = inp["serve"]
    tokens = case["tokens"]
    want = torch_rank_workers._teacher_forced(_jax_tp_engine(
        jcfg, case, num_pages=16, page_size=4,
        batch_bin_floor=tokens.shape[0], page_bin_floor=2,
        len_bin_floor=tokens.shape[1]), tokens, 4)
    for got in res:
        for ref in (got["serve_ref"], want):
            np.testing.assert_array_equal(got["serve_tp"].argmax(-1),
                                          ref.argmax(-1))
            np.testing.assert_allclose(got["serve_tp"], ref,
                                       atol=SERVE_ATOL, rtol=0)
        assert got["pool"] == (2, 16, 4, 4, 4)


def test_lockstep_serving_survives_different_arrival_times(run):
    """Every rank runs a batcher: rank 1's requests arrive 0.1 s apart
    (the API's rank 0's too), and the group still takes rank 0's joins,
    so both ranks stream the tokens of the unsharded engine and of the
    reference's batcher on its engine over a mesh of 2."""
    from horovod_tpu.serve.scheduler import ContinuousBatcher as JaxBatcher
    from horovod_tpu.serve.scheduler import Request as JaxRequest
    inp, res = run
    jcfg, case = inp["serve"]
    batcher = JaxBatcher(_jax_tp_engine(jcfg, case, num_pages=32,
                                        page_size=4), max_batch=2)
    reqs = [JaxRequest(list(p), 6) for p in case["prompts"]]
    for q in reqs:
        batcher.submit(q)
    batcher.drain()
    want = [list(q.generated) for q in reqs]
    assert all(len(t) == 6 for t in want)
    for got in res:
        assert got["batcher_ref"] == want
        assert got["batcher_tp"] == want
        assert got["api_tp"] == want


# ------------------------------------------------ the 3-D combination


def test_model_parallel_3d_combo_zero2_matches_zero0():
    """tests/test_sharding_spec.py:309-355 over 8 gloo ranks on the
    2 x 2 x 2 mesh: a TP trunk with an expert-parallel MoE layer, 3
    compiled SGD steps through the sharding spec at ZeRO-2 and at
    ZeRO-0 from the same shards, within 5e-7 of each other on every
    rank, both in exchange mode ``spec``; the reference's same run
    lies within the reference's gradient band of the port's (3 steps
    of SGD 0.05)."""
    jcfg, cfg = _cfgs(max_seq=16, positional="rope", moe_layers=(1,),
                      moe_num_experts=4)
    tree = _np(jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16),
                                           0, 64))
    targets = np.roll(tokens, -1, axis=1)
    res = spawn_ranks(8, torch_rank_workers.mesh3d,
                      {"cfg": cfg, "tree": tree, "batch": (tokens, targets)},
                      env={"HOROVOD_EXPERT_PARALLEL": "2",
                           "HOROVOD_MODEL_PARALLEL": "2"}, timeout=240)
    want = jax_mesh3d(jax.devices(), expert_parallel=2, model_parallel=2)
    for got in res:
        assert got["shape"] == {"hvd": 2, "ep": 2, "model": 2}
        assert got["mesh"] == [[[d.id for d in row] for row in plane]
                               for plane in want.devices]
        assert got["mode:2"] == got["mode:0"] == "spec"
        for k, v in got["zero2"].items():
            assert np.max(np.abs(v - got["zero0"][k])) <= COMBO_ATOL, k
    ref = _reference_3d(jcfg, tree, tokens, targets)
    for r, got in enumerate(res):
        for k, v in got["zero0"].items():
            np.testing.assert_allclose(v, ref[k][r], atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=k)


def _reference_3d(jcfg, tree, tokens, targets):
    """The reference's 3-step ZeRO-0 run of the same combination; each
    leaf's per-device values by dotted name, in device order."""
    jhvd.shutdown()
    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_EXPERT_PARALLEL", "2")
    mp.setenv("HOROVOD_MODEL_PARALLEL", "2")
    try:
        jhvd.init()
        mesh = jhvd.model_mesh()
        axes = jtfm.ShardAxes(dp=None, sp=None, tp="model", ep="ep")
        from jax.sharding import NamedSharding
        batch = NamedSharding(mesh, P(("hvd", "ep")))
        x = jax.device_put(tokens, batch)
        y = jax.device_put(targets, batch)
        tx = jhvd.DistributedOptimizer(
            optax.sgd(0.05), expert_keys=("['moe']['w1']", "['moe']['w2']"),
            model_keys=jtfm.model_parallel_keys(jcfg, axes), zero_stage=0)
        step = jhvd.compiled_train_step(
            lambda p, t, g: jtfm.loss_fn(p, t, g, jcfg, axes), tx,
            donate=False)
        p = jtfm.slice_param_shards(jax.tree.map(jnp.asarray, tree),
                                    jtfm.param_specs(jcfg, axes), mesh)
        s = step.init(p)
        for _ in range(3):
            p, s, _ = step(p, s, x, y)
        devs = list(mesh.devices.flat)
        out = {}
        for path, leaf in tree_flatten_with_path(p)[0]:
            by_dev = {sh.device: np.asarray(sh.data)
                      for sh in leaf.addressable_shards}
            out[_path_name(path)] = [by_dev[d] for d in sorted(
                devs, key=lambda d: d.id)]
        return out
    finally:
        jhvd.shutdown()
        mp.undo()


# ------------------------------------------------------ spec errors


@pytest.mark.parametrize("kw", [
    {"model_keys": ("w1",)},
    {"model_keys": ("w1",), "model_axis": "ep", "expert_keys": ("moe",),
     "expert_axis": "ep"},
    {"model_keys": ("w1",), "model_axis": "hvd"},
])
def test_model_keys_errors_match_the_reference(kw):
    """``model_keys`` without a ``model_axis``, the same axis for expert
    and model leaves, a model axis that is a data axis: the reference's
    ``_ShardingSpec`` errors, word for word."""
    with pytest.raises(ValueError) as want:
        JSpec(data_axes="hvd", **kw)
    with pytest.raises(ValueError) as got:
        _ShardingSpec("hvd", **kw)
    assert str(got.value) == str(want.value)


def test_a_leaf_matched_by_both_key_sets_raises():
    """A parameter both key sets match raises in the reference's words
    (the port names the parameter where the reference prints its tree
    path)."""
    jspec = JSpec(data_axes="hvd", expert_axis="ep", expert_keys=("w1",),
                  model_axis="model", model_keys=("w1",))
    with pytest.raises(ValueError) as want:
        jspec.leaf_specs({"w1": jnp.zeros(2)}, ("hvd", "ep", "model"))
    spec = _ShardingSpec.__new__(_ShardingSpec)
    spec.expert_keys, spec.model_keys = ("w1",), ("w1",)
    with pytest.raises(ValueError) as got:
        spec.kind("w1")
    assert str(want.value).replace("['w1']", "w1") == str(got.value)


def test_model_axis_collision_needs_distinct_axes():
    with pytest.raises(ValueError, match="must differ"):
        _ShardingSpec("hvd", "model", ("moe",), "model", ("w1",))
    with pytest.raises(ValueError, match="need a model_axis"):
        _ShardingSpec("hvd", model_keys=("w1",))


def test_chunked_sharded_cross_entropy_matches_the_full_loss(run):
    """tests/test_models.py:353: the chunked cross entropy under tp 2
    (the vocab psums inside each chunk) against the reference's full
    logits loss, unsharded."""
    inp, res = run
    jcfg, case = inp["grads"]["chunked"]
    ref = float(jtfm.loss_fn(case["tree"], *case["batch"],
                             dataclasses.replace(jcfg, loss_chunk=None)))
    for got in res:
        np.testing.assert_allclose(got["grads:chunked"][0], ref,
                                   rtol=LOSS_RTOL)
