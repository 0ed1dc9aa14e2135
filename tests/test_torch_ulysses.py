"""Ulysses sequence parallelism: the port (horovod_tpu_torch) against the
JAX package, on the CPU.

The same numpy inputs go through ``horovod_tpu.parallel.ulysses`` under
``shard_map`` over the conftest's virtual XLA devices and through the
port's ``ulysses_attention`` in both forms of its axis:

- local (``RingAxis.local(n)``: every shard in this process, the
  re-shard a head slice), against the reference's gathered output and
  gradients;
- over a process group (8 gloo ranks, tests/torch_ranks.py, what each
  rank runs in tests/torch_rank_workers.py ``ulysses``; the sp group of
  ``create_mesh(sp=n)``), each rank's shard against the reference's.

The model cases are tests/test_models.py's Ulysses cases (:255 dp x sp
x tp, :300 GQA, :516 rope, :570 window): over the dp 2 x sp 2 x tp 2
mesh of gloo ranks, and on a local axis (with gradients there), each
against the reference's single-device loss.

Tolerances are the reference's (tests/test_ulysses.py,
tests/test_models.py): outputs 2e-5, gradients 3e-5, model losses rtol
2e-4, model gradients atol 5e-4 and rtol 5e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu.models.transformer as jtfm
from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import pipeline
from horovod_tpu_torch.parallel.ring_attention import RingAxis, ring_attention
from horovod_tpu_torch.parallel.ulysses import ulysses_attention
from torch_ranks import spawn_ranks
import torch_rank_workers

OUT_ATOL, GRAD_ATOL = 2e-5, 3e-5
LOSS_RTOL = 2e-4
MODEL_GRAD_ATOL, MODEL_GRAD_RTOL = 5e-4, 5e-3
ATTN_SHAPE = (2, 32, 8, 16)   # B, S, H, D (tests/test_ulysses.py:22)
GRAD_SHAPE = (1, 16, 4, 8)    # (tests/test_ulysses.py:35)
BASE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64)
MODEL_CASES = {
    "mha": dict(sp_impl="ulysses"),
    "gqa": dict(sp_impl="ulysses", n_heads=8, n_kv_heads=4),
    "rope_ring": dict(sp_impl="ring", positional="rope"),
    "rope_ulysses": dict(sp_impl="ulysses", positional="rope"),
    "window_ulysses": dict(sp_impl="ulysses", attention_window=8),
    "window_ring": dict(sp_impl="ring", attention_window=8),
    "window_ring_flash": dict(sp_impl="ring", attention_window=8,
                              attention_impl="flash"),
}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_ulysses(n, causal, attn_fn=None):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    return jax.jit(jax.shard_map(
        lambda a, b, c: jax_ulysses(a, b, c, "sp", causal=causal,
                                    attn_fn=attn_fn),
        mesh=mesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"),
        check_vma=False))


def _cfgs(**kw):
    """The (JAX, port) configurations of the same f32 model; the JAX
    one always attends densely (its single-device loss is the
    reference of every sharded run)."""
    kw = {**BASE, **kw}
    jkw = {k: v for k, v in kw.items() if k != "attention_impl"}
    return (jtfm.TransformerConfig(dtype=jnp.float32, **jkw),
            tfm.TransformerConfig(dtype=torch.float32, **kw))


@functools.lru_cache(maxsize=None)
def _case(name):
    jcfg, cfg = _cfgs(**MODEL_CASES[name])
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tokens = np.random.default_rng(1).integers(0, 64, (4, 32))
    return jcfg, {"cfg": cfg, "tree": tree,
                  "batch": (tokens, np.roll(tokens, -1, axis=1))}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(loss, gradient tree) of the reference's single-device model."""
    jcfg, case = _case(name)
    tokens, targets = case["batch"]
    return jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, tokens, targets, jcfg)))(case["tree"])


@pytest.fixture(scope="module")
def ranks():
    q, k, v = _arrays(0, *[ATTN_SHAPE] * 3)
    gq, gk, gv = _arrays(1, *[GRAD_SHAPE] * 3)
    cases = {name: _case(name) for name in MODEL_CASES}
    inp = {"attn": dict(q=q, k=k, v=v), "grad": dict(q=gq, k=gk, v=gv),
           "models": {name: c for name, (_, c) in cases.items()}}
    return inp, cases, spawn_ranks(8, torch_rank_workers.ulysses, inp,
                                   timeout=240)


# ------------------------------------------------- ulysses_attention


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_local_ulysses_matches_jax(sp, causal):
    q, k, v = _arrays(0, *[ATTN_SHAPE] * 3)
    want = _jax_ulysses(sp, causal)(q, k, v)
    got = ulysses_attention(*map(torch.from_numpy, (q, k, v)),
                            RingAxis.local(sp), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)


@pytest.mark.parametrize("h_kv", [4, 2])
def test_local_ulysses_gradients_match_jax(h_kv):
    """The gradients of ``sum(out**2)``, MHA and GQA (2 query heads a
    K/V head at sp 2: each shard holds whole groups)."""
    b, s, h, d = GRAD_SHAPE
    sp = 4 if h_kv == 4 else 2
    q, k, v = _arrays(1, (b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d))
    uly = _jax_ulysses(sp, True)
    want = jax.grad(lambda *x: (uly(*x) ** 2).sum(), argnums=(0, 1, 2))(
        q, k, v)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (ulysses_attention(*xs, RingAxis.local(sp)) ** 2).sum().backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL)


def test_ulysses_flash_attn_fn():
    """The ``attn_fn`` hook with the flash kernels (their plain versions
    on the CPU) at H/n heads, against the reference's hook with the
    Pallas kernel in interpret mode."""
    b, s, h, d = 1, 64, 4, 16
    q, k, v = _arrays(2, *[(b, s, h, d)] * 3)

    def jattn(qg, kg, vg, causal, scale):
        assert scale is None
        return jax_flash(qg, kg, vg, causal=causal, block_size=32,
                         interpret=True)

    want = _jax_ulysses(4, True, jattn)(q, k, v)
    n0 = fa.launches + fa.wgmma_launches
    got = ulysses_attention(
        *map(torch.from_numpy, (q, k, v)), RingAxis.local(4),
        attn_fn=lambda qg, kg, vg, causal, scale: fa.flash_attention(
            qg, kg, vg, causal))
    assert fa.launches + fa.wgmma_launches == n0  # the CPU launches none
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)


@pytest.mark.parametrize("h,h_kv", [(3, 3), (4, 2)])
def test_ulysses_divisibility_errors_match_the_reference(h, h_kv):
    """3 heads, or 2 K/V heads, on an axis of 4: the reference's errors
    word for word (axis named ``sp``)."""
    q = np.ones((1, 16, h, 8), np.float32)
    kv = np.ones((1, 16, h_kv, 8), np.float32)
    with pytest.raises(ValueError) as want:
        _jax_ulysses(4, True)(q, kv, kv)
    with pytest.raises(ValueError) as got:
        ulysses_attention(torch.from_numpy(q), torch.from_numpy(kv),
                          torch.from_numpy(kv), RingAxis.local(4))
    assert str(got.value) == str(want.value)
    assert "divisible" in str(got.value)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_group_ulysses_matches_jax(ranks, sp, causal):
    """Each rank's shard over the sp group of 8 ranks against the
    reference's output at that shard; the rank holds shard
    ``mesh.get_local_rank("sp")``."""
    inp, _, res = ranks
    a = inp["attn"]
    want = np.asarray(_jax_ulysses(sp, causal)(a["q"], a["k"], a["v"]))
    size = ATTN_SHAPE[1] // sp
    for r in res:
        j, local = r[f"shard{sp}"]
        assert j == local
        np.testing.assert_allclose(r[f"attn{sp}{causal}"],
                                   want[:, j * size:(j + 1) * size],
                                   atol=OUT_ATOL)


def test_group_ulysses_gradients_match_jax(ranks):
    """Per-shard gradients over the sp group of 4 (the all-to-all's
    backward is the inverse all-to-all) against the reference's."""
    inp, _, res = ranks
    g = inp["grad"]
    uly = _jax_ulysses(4, True)
    want = jax.grad(lambda *x: (uly(*x) ** 2).sum(), argnums=(0, 1, 2))(
        g["q"], g["k"], g["v"])
    size = GRAD_SHAPE[1] // 4
    for r in res:
        j = r["shard4"][0]
        for got, w in zip(r["grad"], want):
            np.testing.assert_allclose(
                got, np.asarray(w)[:, j * size:(j + 1) * size],
                atol=GRAD_ATOL)


# ------------------------------------------------------- the model


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_over_dp_sp_tp_matches_the_reference(ranks, name):
    """dp 2 x sp 2 x tp 2 over 8 gloo ranks (the dp mean taken outside
    the model, as ``DistributedOptimizer`` averages over dp) against the
    reference's single-device loss, tests/test_models.py's band."""
    _, _, res = ranks
    want = float(_reference(name)[0])
    for r in res:
        np.testing.assert_allclose(r[f"model:{name}"], want, rtol=LOSS_RTOL)


def test_the_window_changes_the_function():
    jcfg, case = _case("window_ulysses")
    full = dataclasses.replace(jcfg, attention_window=None)
    loss = jax.jit(lambda p, t, y: jtfm.loss_fn(p, t, y, full))
    assert float(_reference("window_ulysses")[0]) != float(
        loss(case["tree"], *case["batch"]))


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_on_a_local_axis_matches_the_reference(name):
    """The same cases with every sequence shard in this process
    (``RingAxis.local(2)``): the loss, and every gradient against the
    reference's single-device gradient."""
    _, case = _case(name)
    tokens, targets = case["batch"]
    want_loss, want = _reference(name)
    params = tfm.params_from_jax(case["tree"], case["cfg"], "cpu")
    for t in tfm._leaves(params):
        t.requires_grad_()
    loss = tfm.loss_fn(params, torch.from_numpy(tokens),
                       torch.from_numpy(targets), case["cfg"],
                       tfm.ShardAxes(sp=RingAxis.local(2)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    got = dict(tfm._named_leaves(params))
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        np.testing.assert_allclose(got[name].grad.numpy(), np.asarray(w),
                                   atol=MODEL_GRAD_ATOL,
                                   rtol=MODEL_GRAD_RTOL, err_msg=name)


def test_sp_impl_is_carried_and_validated():
    """``sp_impl="ulysses"`` builds (it raised before this slice), and an
    unknown one raises the reference's error."""
    assert _cfgs(sp_impl="ulysses")[1].sp_impl == "ulysses"
    with pytest.raises(ValueError, match="sp_impl"):
        tfm.TransformerConfig(vocab_size=8, d_model=8, n_heads=2,
                              n_layers=1, d_ff=8, max_seq=8, sp_impl="nope")


# ------------------------------------------------- the kernels' route


def test_tensor_core_route_takes_the_head_slices():
    """The flagship's Ulysses shard at H 16 / H_kv 4 over a local axis
    of 4: each shard's q, k and v are head slices of the projections
    (H 4 / H_kv 1), whose base pointers sit j*(H/n)*D elements on and
    whose strides stay H*D and D; the size-1 head dim of k/v gets its
    dense stride. Every slice takes the tensor cores; a head dim the
    route does not take, or a slice off 16-byte alignment, does not."""
    b, s, h, h_kv, d, n = 2, 64, 16, 4, 128, 4
    q = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    kv = torch.zeros((b, s, 2, h_kv, d), dtype=torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    for j in range(n):
        qj = q[:, :, j * 4:(j + 1) * 4]
        kj, vj = k[:, :, j:j + 1], v[:, :, j:j + 1]
        assert qj.data_ptr() - q.data_ptr() == j * 4 * d * 2
        assert fa._strides(qj) == [s * h * d, h * d, d]
        assert fa._strides(kj) == [s * 2 * h_kv * d, 2 * h_kv * d, d]
        assert fa.tensor_core_route(qj, kj, vj)
        assert fa.tensor_core_route(qj, kj, vj, qj.contiguous())
    wide = torch.zeros((b, s, h, 72), dtype=torch.bfloat16)
    assert not fa.tensor_core_route(wide[:, :, :4], wide[:, :, :1],
                                    wide[:, :, :1])
    odd = torch.zeros((b, s, h, d + 4), dtype=torch.bfloat16)[..., 4:]
    assert not fa.tensor_core_route(odd, odd, odd)


# ------------------------------------------------------ capture


def test_a_process_group_step_refuses_capture(monkeypatch):
    """Under a CUDA graph capture, Ulysses, the ring and the pipeline's
    shift over a process group raise naming the ROADMAP entry (gloo
    cannot be captured, NCCL needs a card a rank); a local axis runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    group = RingAxis(2, (0,), group=object())
    x = torch.zeros((1, 4, 2, 8))
    for call in (lambda: ulysses_attention(x, x, x, group),
                 lambda: ring_attention(x, x, x, group),
                 lambda: pipeline.shift(group, x)):
        with pytest.raises(NotImplementedError,
                           match="Waiting for several cards"):
            call()
    assert ulysses_attention(x, x, x, RingAxis.local(2)).shape == x.shape
