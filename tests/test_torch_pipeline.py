"""Pipeline parallelism: the port (horovod_tpu_torch) against the JAX
package, on the CPU, one port test per test of tests/test_pipeline.py.

Two forms of the pp axis:

- local (``RingAxis.local(S)``: every stage in this process, the
  stacked tree whole), against the reference's gathered values, the
  gradients of ``jax.grad`` through its ``shard_map``;
- over a process group (8 gloo ranks, tests/torch_ranks.py; what each
  rank runs is tests/torch_rank_workers.py ``pipelines``; each case on
  its own ``create_mesh``, dp taking the ranks it leaves), each rank
  against the reference's per-shard values.

Per-rank gradients over a process group. 1F1B returns what the
reference's ``pipeline_value_and_grad_1f1b`` returns per shard: the
stacked layers' block of this rank's stage, the embedding and head
summed over pp, leaves replicated over tp summed over tp, everything
averaged over sp. GPipe is differentiated by autograd on each rank: a
rank's gradient is its own paths' (last_stage_value passes the
cotangent through, as the reference's psum after ``shard_map``'s
division of the replicated loss's cotangent does), the port's psums
transpose to psums as the reference's do under ``check_vma=False``
(tests/test_torch_tensor_parallel.py): summed over pp and tp where a
leaf is replicated, concatenated where it is split, and averaged over
sp, the ranks' gradients give tp times the unsharded gradient.

The two pipeline x MoE gradient cases the reference skips on this box
(``backend_caps.supports_pipeline_moe_grad``: its ``shard_map`` cannot
differentiate them here) are held against the port's own unpipelined
model, the per-microbatch mean of ``loss_fn``, and their losses against
the reference's per-microbatch estimator.

Tolerances are the reference's: losses rtol and atol 2e-5 (the toy's
1e-5), gradients rtol 1e-4 and atol 1e-5 (the toy's atol 1e-6), MoE
gradients rtol 2e-4 and atol 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from jax.tree_util import tree_flatten_with_path

import horovod_tpu.models.transformer as jtfm
from horovod_tpu.parallel import create_mesh as jax_create_mesh
from horovod_tpu.parallel import pipeline as jpl
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel import pipeline as pl
from horovod_tpu_torch.parallel.mesh import MeshConfig, create_mesh
from horovod_tpu_torch.parallel.ring_attention import RingAxis
from torch_ranks import spawn_ranks
import torch_rank_workers

LOSS_TOL, TOY_LOSS_RTOL = 2e-5, 1e-5
GRAD_RTOL, GRAD_ATOL, TOY_GRAD_ATOL = 1e-4, 1e-5, 1e-6
MOE_RTOL, MOE_ATOL = 2e-4, 2e-5

# The reference's toy (tests/test_pipeline.py:139-154).
TOY_W = np.array([1.1, 0.9, 1.2, 0.8], np.float32)
TOY_SHARED = {"win": np.float32(0.7), "wout": np.float32(1.3)}
TOY_XS = np.linspace(-1.0, 1.0, 24, dtype=np.float32).reshape(6, 4)
# (M, V, gated): the core at M 6 and 2, interleaved at M 6/4/5, gated
# at (6, 1), (6, 2), (4, 2).
TOYS = {"core6": (6, 1, False), "core2": (2, 1, False),
        "inter6": (6, 2, False), "inter4": (4, 2, False),
        "inter5": (5, 2, False), "gated61": (6, 1, True),
        "gated62": (6, 2, True), "gated42": (4, 2, True)}
MODELS = {
    # name: (config keywords, mesh, runs, interleave)
    "pp2": ({}, dict(pp=2), ("gpipe", "1f1b"), 1),
    "pp2tp2": (dict(d_model=32, n_heads=4, d_ff=64, vocab_size=128),
               dict(pp=2, tp=2), ("gpipe",), 1),
    "pp4": ({}, dict(pp=4), ("gpipe",), 1),
    "pp2sp2tp2": ({}, dict(pp=2, sp=2, tp=2), ("gpipe", "1f1b"), 1),
    "chunked": (dict(loss_chunk=8), dict(pp=2), ("gpipe", "1f1b"), 1),
    "interleaved": ({}, dict(pp=2), ("1f1b",), 2),
    "moe": (dict(n_layers=2, moe_layers=(0, 1), moe_num_experts=4,
                 moe_top_k=1), dict(pp=2, ep=2), ("gpipe", "1f1b"), 1),
    "mixed": (dict(moe_layers=(1, 3), moe_num_experts=4, moe_top_k=1),
              dict(pp=2, ep=2), ("gpipe", "1f1b"), 1),
    "mixed_interleaved": (dict(n_layers=8, moe_layers=(1, 3, 5, 7),
                               moe_num_experts=2, moe_top_k=1),
                          dict(pp=2), ("1f1b",), 2),
}


def _cfgs(**kw):
    """The (JAX, port) configurations of the reference's tiny f32
    pipeline model (tests/test_pipeline.py:21)."""
    kw = {**dict(vocab_size=64, d_model=16, n_heads=2, n_layers=4, d_ff=32,
                 max_seq=16), **kw}
    return (jtfm.TransformerConfig(dtype=jnp.float32, **kw),
            tfm.TransformerConfig(dtype=torch.float32, **kw))


def _case(name):
    kw, mesh, runs, v = MODELS[name]
    jcfg, cfg = _cfgs(**kw)
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (8, 16),
                                         0, jcfg.vocab_size))
    return jcfg, {"cfg": cfg, "tree": tree, "mesh": mesh, "runs": runs,
                  "interleave": v,
                  "batch": (tokens, np.roll(tokens, -1, axis=1))}


def _path_name(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _named(tree):
    return {_path_name(p): np.asarray(x)
            for p, x in tree_flatten_with_path(tree)[0]}


def _torch_tree(case):
    return tfm.params_from_jax(case["tree"], case["cfg"], "cpu")


def _reference_grads(jcfg, case, stack=True):
    """(loss, {name: gradient}) of the reference's single-device loss,
    the layers stacked as the case's pipelined layout."""
    tokens, targets = case["batch"]
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, tokens, targets, jcfg)))(case["tree"])
    if stack:
        g = jtfm.stack_pipeline_params(g, interleave=case["interleave"],
                                       num_stages=case["mesh"]["pp"])
    return float(loss), _named(g)


def _port_estimator(case):
    """(loss, {name: gradient}) of the port's own unpipelined model: the
    mean over the 4 microbatches of ``loss_fn`` (the reference's
    estimator of a pipelined MoE loss), layers stacked."""
    cfg = case["cfg"]
    params = _torch_tree(case)
    for t in tfm._leaves(params):
        t.requires_grad_()
    tokens, targets = (torch.from_numpy(a).reshape(4, 2, -1)
                       for a in case["batch"])
    loss = sum(tfm.loss_fn(params, tokens[i], targets[i], cfg)
               for i in range(4)) / 4
    loss.backward()
    grads = tfm._tree_map(lambda t: t.grad, params)
    grads = tfm.stack_pipeline_params(grads, interleave=case["interleave"],
                                      num_stages=case["mesh"]["pp"])
    return loss.item(), {k: t.numpy() for k, t in tfm._named_leaves(grads)}


def _reference_estimator(jcfg, case):
    tokens, targets = (a.reshape(4, 2, -1) for a in case["batch"])
    loss = jax.jit(lambda p, t, y: jtfm.loss_fn(p, t, y, jcfg))
    return float(np.mean([float(loss(case["tree"], tokens[i], targets[i]))
                          for i in range(4)]))


def _combine(res, key, specs, replicated):
    """One tree of the ranks' per-rank gradients ``r[key]``: a dim split
    over an axis concatenated in rank order, an axis a leaf is
    replicated over reduced by ``replicated[axis]`` ("sum", "mean" or
    "first"), the data-parallel replicas' first."""
    ranks = [r for r in res if r["coords"]["dp"][0] == 0]
    out = {}
    for name, spec in tfm._named_leaves(specs):
        vals = {tuple(r["coords"][a][0] for a in ("pp", "ep", "sp", "tp")):
                r[key][1][name] for r in ranks}
        for pos, axis in enumerate(("pp", "ep", "sp", "tp")):
            groups = {}
            for c, x in vals.items():
                groups.setdefault(c[:pos] + c[pos + 1:], []).append(
                    (c[pos], x))
            merged = {}
            for rest, items in groups.items():
                xs = [x for _, x in sorted(items, key=lambda i: i[0])]
                if axis in spec:
                    x = np.concatenate(xs, axis=spec.index(axis))
                elif replicated.get(axis, "first") == "sum":
                    x = np.sum(xs, axis=0)
                elif replicated.get(axis, "first") == "mean":
                    x = np.mean(xs, axis=0)
                else:
                    x = xs[0]
                merged[rest[:pos] + (0,) + rest[pos:]] = x
            vals = merged
        out[name] = vals[(0, 0, 0, 0)]
    return out


@pytest.fixture(scope="module")
def ranks():
    models = {name: _case(name) for name in MODELS}
    inp = {"toy": {"w": TOY_W, "shared": TOY_SHARED, "xs": TOY_XS},
           "toys": TOYS,
           "models": {name: c for name, (_, c) in models.items()}}
    return models, spawn_ranks(8, torch_rank_workers.pipelines, inp,
                               timeout=240)


# --------------------------------------------------------- the mesh


@pytest.mark.parametrize("kw", [dict(pp=2), dict(pp=4), dict(pp=2, tp=2),
                                dict(pp=2, sp=2, tp=2), dict(pp=2, ep=2)])
def test_create_mesh_layout_matches_the_reference(ranks, kw):
    """Every rank's 5-D mesh (``("pp", "dp", "ep", "sp", "tp")``, dp the
    rest) holds the reference's device ids at every position."""
    _, res = ranks
    want = jax_create_mesh(devices=jax.devices()[:8], **kw)
    key = f"mesh{tuple(sorted(kw.items()))}"
    ids = np.vectorize(lambda d: d.id)(want.devices).tolist()
    assert want.axis_names == ("pp", "dp", "ep", "sp", "tp")
    for r in res:
        assert r[key] == ids


@pytest.mark.parametrize("n,kw", [(8, dict(tp=3)), (8, dict(dp=3, tp=2)),
                                  (6, dict(pp=4)), (8, dict(dp=1, pp=2))])
def test_create_mesh_errors_match_the_reference(n, kw):
    with pytest.raises(ValueError) as want:
        jax_create_mesh(devices=jax.devices()[:1] * n, **kw)
    with pytest.raises(ValueError) as got:
        create_mesh("cpu", n, **kw)
    assert str(got.value) == str(want.value)
    assert MeshConfig() == MeshConfig(dp=-1, tp=1, pp=1, sp=1, ep=1)


# ---------------------------------------------------- stacking, specs


def test_stack_unstack_roundtrip():
    jcfg, cfg = _cfgs()
    params = _torch_tree({"cfg": cfg, "tree": jax.tree.map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(0), jcfg))})
    back = pl.unstack_layers(pl.stack_layers(params["layers"]))
    for orig, rt in zip(params["layers"], back):
        for k in orig:
            assert torch.equal(orig[k], rt[k])


@pytest.mark.parametrize("name", ["pp2", "interleaved", "mixed",
                                  "mixed_interleaved"])
def test_stacked_layouts_and_specs_match_the_reference(name):
    """``stack_pipeline_params`` (converted per layer, stacked after)
    leaf for leaf and ``pipeline_param_specs`` entry for entry against
    the reference's, homogeneous, interleaved (V, S, L', ...) and the
    mixed dense/MoE per-position layouts; and the stage a rank cuts with
    ``slice_param_shards`` is the reference's block."""
    jcfg, case = _case(name)
    v, s = case["interleave"], case["mesh"]["pp"]
    want = jtfm.stack_pipeline_params(case["tree"], interleave=v,
                                      num_stages=s)
    got = tfm.stack_pipeline_params(_torch_tree(case), interleave=v,
                                    num_stages=s)
    if "mixed" in name:
        assert isinstance(got["layers"], list)
        assert len(got["layers"]) == len(want["layers"]) == 2
    got_named = {k: t.numpy() for k, t in tfm._named_leaves(got)}
    want_named = _named(want)
    assert sorted(got_named) == sorted(want_named)
    for k, w in want_named.items():
        np.testing.assert_array_equal(got_named[k], w, err_msg=k)
    jspecs = jtfm.pipeline_param_specs(
        jcfg, jtfm.ShardAxes(dp=None, sp=None, tp="tp", ep="ep"),
        interleave=v, num_stages=s)
    specs = tfm.pipeline_param_specs(case["cfg"], tp="tp", interleave=v,
                                     num_stages=s)
    want_specs = {_path_name(p): tuple(x) for p, x in tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, P))[0]}
    assert dict(tfm._named_leaves(specs)) == want_specs
    stage = tfm.slice_param_shards(got, specs, {"pp": (1, s)})
    for k, t in tfm._named_leaves(stage):
        want_k = want_named[k]
        if "pp" in want_specs[k]:
            want_k = np.split(want_k, s, axis=want_specs[k].index("pp"))[1]
        np.testing.assert_array_equal(t.numpy(), want_k, err_msg=k)


def test_mixed_kind_patterns_raise_the_reference_errors():
    """A kind pattern that differs across pipeline units, and a mixed
    model without a stage count, raise as the reference does."""
    _, cfg = _cfgs(n_layers=2, moe_layers=(1,), moe_num_experts=4)
    with pytest.raises(NotImplementedError, match="kind pattern"):
        tfm._check_pipeline_moe(cfg, num_stages=2)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((8, 16), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="stage count"):
        tfm.pipeline_loss_fn(params, tokens, tokens, cfg,
                             num_microbatches=4)


# ------------------------------------------------------------ GPipe


def test_generic_pipeline_matches_sequential(ranks):
    """The toy 2-stage pipeline (stage s multiplies by w[s]), local and
    over 2 ranks: every microbatch times 6."""
    _, res = ranks
    xs = torch.arange(12.0).reshape(4, 3)
    w = torch.tensor([2.0, 3.0])
    axis = RingAxis.local(2)
    out = pl.last_stage_value(
        pl.pipeline(lambda s, x: x * w[s], xs, axis, num_microbatches=4),
        axis)
    np.testing.assert_allclose(out.numpy(), xs.numpy() * 6.0)
    for r in res:
        np.testing.assert_allclose(r["toy_gpipe"], xs.numpy() * 6.0)


@pytest.mark.parametrize("name", ["pp2", "pp2tp2", "pp4"])
def test_pipeline_transformer_loss_matches_sequential(ranks, name):
    """GPipe's loss at (pp, tp) (2, 1), (2, 2), (4, 1) over the ranks,
    and at pp 2 and 4 on a local axis, against the reference's
    single-device loss."""
    models, res = ranks
    jcfg, case = models[name]
    want = _reference_grads(jcfg, case)[0]
    for r in res:
        np.testing.assert_allclose(r[f"model:{name}"]["gpipe"][0], want,
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    if name != "pp2tp2":
        stacked = tfm.stack_pipeline_params(_torch_tree(case))
        loss = tfm.pipeline_loss_fn(
            stacked, *map(torch.from_numpy, case["batch"]), case["cfg"],
            num_microbatches=4, pp=RingAxis.local(case["mesh"]["pp"]))
        np.testing.assert_allclose(loss.item(), want, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)


def test_pipeline_transformer_grads_match_sequential(ranks):
    """GPipe's gradients through autograd: pp 2 x sp 2 x tp 2 over the
    ranks (module docstring: the ranks' gradients make tp times the
    unsharded one), and pp 2 on a local axis (the unsharded gradient
    itself), against the reference's single-device gradients."""
    models, res = ranks
    jcfg, case = models["pp2sp2tp2"]
    _, want = _reference_grads(jcfg, case)
    specs = tfm.pipeline_param_specs(case["cfg"], tp="tp")
    got = _combine([r["model:pp2sp2tp2"] for r in res], "gpipe", specs,
                   {"pp": "sum", "tp": "sum", "sp": "mean"})
    for k, w in want.items():
        np.testing.assert_allclose(got[k], 2 * w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    stacked = tfm.stack_pipeline_params(_torch_tree(case))
    for t in tfm._leaves(stacked):
        t.requires_grad_()
    tfm.pipeline_loss_fn(stacked, *map(torch.from_numpy, case["batch"]),
                         case["cfg"], num_microbatches=4,
                         pp=RingAxis.local(2)).backward()
    for k, t in tfm._named_leaves(stacked):
        np.testing.assert_allclose(t.grad.numpy(), want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


# ------------------------------------------------------------- 1F1B


def _toy_reference(m):
    w = jnp.asarray(TOY_W)
    shared = {k: jnp.float32(x) for k, x in TOY_SHARED.items()}
    xs = jnp.asarray(TOY_XS)

    def seq(w_, sh):
        def one(mb):
            x = xs[mb] * sh["win"]
            for s in range(4):
                x = jnp.tanh(x * w_[s])
            return jnp.mean((x * sh["wout"] - mb) ** 2)
        return jnp.mean(jnp.stack([one(mb) for mb in range(m)]))

    loss, (dw, dsh) = jax.value_and_grad(seq, argnums=(0, 1))(w, shared)
    return float(loss), np.asarray(dw), {k: float(x) for k, x in dsh.items()}


def _toy_local(m, v, gated):
    """The toy on a local axis of 4 // v stages."""
    runs = {"fwd": 0, "bwd": 0}

    def stage_fn(sp, x):
        runs["bwd" if torch.is_grad_enabled() else "fwd"] += 1
        return torch.tanh(x * sp[0])

    w = torch.from_numpy(TOY_W)
    loss, d_w, d_sh = pl.pipeline_1f1b(
        stage_fn, w if v == 1 else w.reshape(v, 4 // v),
        {k: torch.tensor(x) for k, x in TOY_SHARED.items()},
        torch.from_numpy(TOY_XS[:m]), RingAxis.local(4 // v),
        num_microbatches=m, inject_fn=lambda sh, raw: raw * sh["win"],
        loss_fn=lambda sh, y, mb: torch.mean((y * sh["wout"] - mb) ** 2),
        num_chunks=v, stage_collectives=not gated)
    return (loss.item(), d_w.reshape(-1).numpy(),
            {k: float(g) for k, g in d_sh.items()}, runs)


def _check_toy(got, want):
    (loss, dw, dsh), (wl, wdw, wdsh) = got[:3], want
    np.testing.assert_allclose(loss, wl, rtol=TOY_LOSS_RTOL)
    np.testing.assert_allclose(dw, wdw, rtol=GRAD_RTOL, atol=TOY_GRAD_ATOL)
    for k in wdsh:
        np.testing.assert_allclose(dsh[k], wdsh[k], rtol=GRAD_RTOL,
                                   atol=TOY_GRAD_ATOL, err_msg=k)


def _toy_group(res, key, v):
    """The ranks' toy results as one: the stage blocks of ``d_w`` in
    virtual-stage order (chunk-major), loss and shared from rank 0."""
    by_stage = {}
    for r in res:
        (s, n), got = r[f"toy:{key}"]
        by_stage[s] = got
    dw = np.concatenate([by_stage[s][1][c] for c in range(v)
                         for s in range(len(by_stage))]) if v > 1 else \
        np.concatenate([by_stage[s][1] for s in range(len(by_stage))])
    loss, _, dsh, _ = by_stage[0]
    for got in by_stage.values():
        assert got[0] == loss and got[2] == dsh
    return loss, dw.reshape(-1), dsh, by_stage


@pytest.mark.parametrize("key", sorted(TOYS))
def test_1f1b_toy_matches_sequential(ranks, key):
    """The reference's 1F1B toy cases: the core at M 6 and 2 (more and
    fewer microbatches than the 4 stages), interleaved (V 2 on 2 stages)
    at M 6, 4 and 5 (5: partial groups), and gated at (M, V) (6, 1),
    (6, 2), (4, 2): local and over the ranks, against
    ``jax.value_and_grad`` of the sequential toy."""
    _, res = ranks
    m, v, gated = TOYS[key]
    want = _toy_reference(m)
    _check_toy(_toy_local(m, v, gated), want)
    _check_toy(_toy_group(res, key, v), want)


@pytest.mark.parametrize("key", ["core6", "gated61", "gated62", "gated42"])
def test_1f1b_runs_the_stage_as_the_gated_slot_algebra_says(ranks, key):
    """The port skips inactive slots (parallel/pipeline.py), so its
    schedule runs each stage exactly as often as the reference's gated
    program does: one forward phase per active F slot and one recompute
    per active B slot of the reference's slot algebra, M*V each, with
    or without ``stage_collectives``."""
    _, res = ranks
    m, v, _ = TOYS[key]
    n = 4 // v
    slots, f_act, b_act = jpl._slot_algebra(n, m, v)
    for s in range(n):
        f = sum(bool(f_act(s, u)[0]) for u in range(slots))
        b = sum(bool(b_act(s, u)[0]) for u in range(slots))
        assert f == b == m * v
    assert _toy_local(m, v, False)[3] == {"fwd": n * m * v, "bwd": n * m * v}
    for s, got in _toy_group(res, key, v)[3].items():
        assert got[3] == {"fwd": m * v, "bwd": m * v}


@pytest.mark.parametrize("s,m", [(4, 6), (2, 2), (3, 7)])
def test_1f1b_schedule_slot_count(s, m):
    """One loop of M + 2S - 2 super-slots at V 1, the reference's slot
    algebra's count; and the stash ring's capacity."""
    assert pl._slot_algebra(s, m, 1)[0] == m + 2 * s - 2 \
        == jpl._slot_algebra(s, m, 1)[0]
    assert pl.stash_capacity(s) == 2 * s - 1
    assert pl.stash_capacity(s, 2) == 2 * s


def test_1f1b_transformer_matches_sequential(ranks):
    """The transformer's 1F1B (loss, grads) at pp 2 x sp 2 x tp 2 over
    the ranks (each rank the reference's per-shard gradient) and at pp 2
    on a local axis, against the single-device reference."""
    models, res = ranks
    jcfg, case = models["pp2sp2tp2"]
    want_loss, want = _reference_grads(jcfg, case)
    specs = tfm.pipeline_param_specs(case["cfg"], tp="tp")
    results = [r["model:pp2sp2tp2"] for r in res]
    for r in results:
        np.testing.assert_allclose(r["1f1b"][0], want_loss, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
    got = _combine(results, "1f1b", specs, {})
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    stacked = tfm.stack_pipeline_params(_torch_tree(case))
    loss, grads = tfm.pipeline_value_and_grad_1f1b(
        stacked, *map(torch.from_numpy, case["batch"]), case["cfg"],
        num_microbatches=4, pp=RingAxis.local(2))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for k, t in tfm._named_leaves(grads):
        np.testing.assert_allclose(t.numpy(), want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_pipeline_loss_chunk(ranks):
    """``loss_chunk`` composes with both schedules: losses and the head's
    gradient at pp 2, over the ranks (GPipe's head gradient summed over
    pp) and locally, against the unchunked single-device reference."""
    models, res = ranks
    jcfg, case = models["chunked"]
    want_loss, want = _reference_grads(
        dataclasses.replace(jcfg, loss_chunk=None), case)
    results = [r["model:chunked"] for r in res]
    got = _combine(results, "gpipe", tfm.pipeline_param_specs(case["cfg"]),
                   {"pp": "sum"})
    np.testing.assert_allclose(got["lm_head"], want["lm_head"],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for r in results:
        for run in ("gpipe", "1f1b"):
            np.testing.assert_allclose(r[run][0], want_loss, rtol=LOSS_TOL,
                                       atol=LOSS_TOL)
        np.testing.assert_allclose(r["1f1b"][1]["lm_head"], want["lm_head"],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    stacked = tfm.stack_pipeline_params(_torch_tree(case))
    _, grads = tfm.pipeline_value_and_grad_1f1b(
        stacked, *map(torch.from_numpy, case["batch"]), case["cfg"],
        num_microbatches=4, pp=RingAxis.local(2))
    np.testing.assert_allclose(grads["lm_head"].numpy(), want["lm_head"],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_1f1b_memory_flat_in_microbatches():
    """1F1B's point: a stage holds at most ``stash_capacity`` inputs, the
    same at M 16 as at M 8 (once M passes 2S - 1), while GPipe's saved
    activations grow with M (4 to 16).
    The stash is read as the bytes of the inputs a stage holds between
    its forward phase and its backward recompute (4 stages, x @ w)."""
    w = torch.ones((4, 64, 64))

    def gpipe_saved(m):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        wg = w.clone().requires_grad_()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = pl.pipeline(lambda s, x: torch.tanh(x @ wg[s]),
                              torch.ones((m, 8, 64)), RingAxis.local(4),
                              num_microbatches=m)
        (out ** 2).sum().backward()
        return total[0]

    def stash_bytes(m):
        held, peak = {}, [0]

        def stage_fn(sp, x):
            key = sp[0, 0, 0].item()
            if torch.is_grad_enabled():
                held[key] -= 1
            else:
                held[key] = held.get(key, 0) + 1
                peak[0] = max(peak[0], max(held.values()))
            return torch.tanh(x @ sp[0])

        ws = torch.stack([w[0] * (1 + s) for s in range(4)])
        pl.pipeline_1f1b(stage_fn, ws, {}, torch.ones((m, 8, 64)),
                         RingAxis.local(4), num_microbatches=m,
                         loss_fn=lambda sh, y, mb: torch.sum(y ** 2))
        assert peak[0] <= pl.stash_capacity(4)
        return peak[0] * 8 * 64 * 4

    g4, g16 = gpipe_saved(4), gpipe_saved(16)
    assert g16 > g4 * 1.8, (g4, g16)
    # the stash fills to min(M, 2S - 1) inputs and stays there
    t4, t8, t16 = stash_bytes(4), stash_bytes(8), stash_bytes(16)
    assert t4 < t8 and t16 <= t8 * 1.1, (t4, t8, t16)


def test_1f1b_interleaved_transformer(ranks):
    """Interleave 2 on pp 2 (4 virtual stages, one layer each): the
    (V, S, L', ...) layout, chunk selection and gradient scatter, over
    the ranks and locally; layer (c*S + s) sits at [c, s, 0]."""
    models, res = ranks
    jcfg, case = models["interleaved"]
    want_loss, want = _reference_grads(jcfg, case)
    specs = tfm.pipeline_param_specs(case["cfg"], interleave=2,
                                     num_stages=2)
    results = [r["model:interleaved"] for r in res]
    got = _combine(results, "1f1b", specs, {})
    for r in results:
        np.testing.assert_allclose(r["1f1b"][0], want_loss, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
    stacked = tfm.stack_pipeline_params(_torch_tree(case), interleave=2,
                                        num_stages=2)
    loss, grads = tfm.pipeline_value_and_grad_1f1b(
        stacked, *map(torch.from_numpy, case["batch"]), case["cfg"],
        num_microbatches=4, pp=RingAxis.local(2), interleave=2)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    local = {k: t.numpy() for k, t in tfm._named_leaves(grads)}
    for k, w in want.items():
        for tree in (got, local):
            np.testing.assert_allclose(tree[k], w, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=k)


# --------------------------------------------------------- MoE x PP


@pytest.mark.parametrize("name", ["moe", "mixed", "mixed_interleaved"])
def test_pipeline_moe_matches_the_unpipelined_model(ranks, name):
    """All-MoE and mixed dense/MoE layers (the per-position layout) at pp
    2 x ep 2 over the ranks, and mixed interleaved at pp 2: the losses of
    both schedules against the reference's per-microbatch estimator;
    1F1B's gradients (each rank the reference's per-shard gradient,
    expert stacks split over ep) against the port's own unpipelined
    model, since the reference cannot differentiate these pipelines on
    this box (module docstring); locally, both schedules' gradients."""
    models, res = ranks
    jcfg, case = models[name]
    v = case["interleave"]
    ref_loss = _reference_estimator(jcfg, case)
    est_loss, est = _port_estimator(case)
    np.testing.assert_allclose(est_loss, ref_loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    specs = tfm.pipeline_param_specs(case["cfg"], interleave=v,
                                     num_stages=2)
    results = [r[f"model:{name}"] for r in res]
    for r in results:
        for run in case["runs"]:
            np.testing.assert_allclose(r[run][0], ref_loss, rtol=LOSS_TOL,
                                       atol=LOSS_TOL)
    got = _combine(results, "1f1b", specs, {})
    stacked = tfm.stack_pipeline_params(_torch_tree(case), interleave=v,
                                        num_stages=2)
    tokens, targets = map(torch.from_numpy, case["batch"])
    loss, grads = tfm.pipeline_value_and_grad_1f1b(
        stacked, tokens, targets, case["cfg"], num_microbatches=4,
        pp=RingAxis.local(2), interleave=v)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    trees = [got, {k: t.numpy() for k, t in tfm._named_leaves(grads)}]
    if v == 1:
        for t in tfm._leaves(stacked):
            t.requires_grad_()
        tfm.pipeline_loss_fn(stacked, tokens, targets, case["cfg"],
                             num_microbatches=4,
                             pp=RingAxis.local(2)).backward()
        trees.append({k: t.grad.numpy()
                      for k, t in tfm._named_leaves(stacked)})
    for k, w in est.items():
        for tree in trees:
            np.testing.assert_allclose(tree[k], w, rtol=MOE_RTOL,
                                       atol=MOE_ATOL, err_msg=k)


# ------------------------------------------------- the cost model


def test_interleaved_cost_model_matches_the_reference():
    """``interleaved_1f1b_cost`` is the reference's, case for case, and
    shows its V-fold gated bubble."""
    for s in (1, 2, 3, 4):
        for m in range(1, 10):
            for v in (1, 2, 3, 4):
                for gated in (False, True):
                    assert pl.interleaved_1f1b_cost(s, m, v, gated) == \
                        jpl.interleaved_1f1b_cost(s, m, v, gated)
    _, _, b1 = pl.interleaved_1f1b_cost(4, 16, 1, gated=True)
    _, _, b4 = pl.interleaved_1f1b_cost(4, 16, 4, gated=True)
    assert b1 == pytest.approx(3.0 * 3)
    assert b4 == pytest.approx(b1 / 4)
    _, _, u1 = pl.interleaved_1f1b_cost(4, 16, 1, gated=False)
    _, _, u4 = pl.interleaved_1f1b_cost(4, 16, 4, gated=False)
    assert u4 > b4 * 3 and u4 > u1 / 2
