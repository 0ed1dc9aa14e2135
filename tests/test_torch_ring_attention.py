"""The port's ring attention, its band tiles and its sequence-parallel
transformer against the JAX package's.

The same inputs, made with numpy, go through both packages on the CPU:

- the band tiles: the port's ``flash_band_fwd``, ``flash_band_dq`` and
  ``flash_band_dkv`` (on a CPU tensor, their plain versions) against
  ``_band_tile_fwd`` and ``_band_tile_bwd`` with the Pallas kernels
  ``_band_fwd_kernel``, ``_band_dq_kernel`` and ``_band_dkv_kernel`` in
  interpret mode, at offsets S and 2S, with windows that leave rows with
  no live key and windows of S or more, with and without GQA;
- ``ring_attention`` on a local ring of 4 against the JAX function under
  ``shard_map`` over 4 of the conftest's virtual devices, forward and
  gradients, both tile implementations;
- ``loss_fn`` of a small f32 transformer with ``ShardAxes(sp=<local ring
  of 4>)`` and a window, ``remat`` off and on, against the JAX
  ``loss_fn`` under ``shard_map`` (the pattern of
  tests/test_models.py::test_transformer_remat_with_ring_sp).

The JAX gradient is taken outside ``jit(shard_map)``:
tests/test_models.py:795-800 records that the other nesting aborts XLA
on the CPU.

The band forward's tensor-core arithmetic, on the CPU: the plain version
with ``operand_dtype=torch.bfloat16`` (p rounded to bf16 before ``p.v``)
stays within ``fwd_bf16_rounding_bound`` of the f32 one and of
``_band_fwd_kernel`` on live rows, keeps dead rows at lse <= -1e29, and
with ``operand_dtype=None`` is the reference's arithmetic; the forward's
route rule takes the ring's ``chunk(dim=1)`` shard views.

Tolerances are the reference's (tests/test_ring_attention.py,
tests/test_models.py): out 2e-5 and lse 1e-4 on rows with a live key,
``lse <= -1e29`` on rows without one; tile and ring gradients 1e-4; the
transformer's loss and gradients 5e-5. A row with no live key in a band
tile has a finite but arbitrary out on both sides (the mean of whatever
V rows the tile visited, which the ring's merge weights by 0), so its
out is not compared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu.models.transformer as jtfm
from horovod_tpu.ops.flash_attention import _band_tile_bwd, _band_tile_fwd
from horovod_tpu.parallel.ring_attention import _tile_masks as jax_tile_masks
from horovod_tpu.parallel.ring_attention import ring_attention as jax_ring
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel.ring_attention import (
    RingAxis, _ring_steps, _split, dense_attention, ring_attention)

OUT_ATOL, LSE_ATOL, GRAD_ATOL, MODEL_ATOL = 2e-5, 1e-4, 1e-4, 5e-5

# (B, S, H, H_kv, D, off, window, block): the JAX kernels run with one
# block (S <= block) or two of 128 (its blocks above one are multiples of
# 128; otherwise it falls back to plain jnp)
BAND_CASES = {
    "off-S-dead-rows-gqa2": (1, 256, 4, 2, 16, 256, 200, 128),
    "off-2S-dead-rows-mha": (1, 128, 2, 2, 16, 256, 200, 128),
    "off-S-window-ge-S-gqa4": (2, 64, 4, 1, 8, 64, 96, 64),
    "off-2S-window-ge-S-gqa2": (1, 256, 4, 2, 8, 512, 600, 128),
}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _band_inputs(case, seed):
    b, s, h, h_kv, d = BAND_CASES[case][:5]
    return _arrays(seed, (b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d),
                   (b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d),
                   (b, h, s))


def _live_rows(s, off, window):
    """Rows of a band tile at offset ``off`` with at least one live key."""
    lo, hi = fa.band_key_span(s, off, window)
    return (lo <= hi).numpy()


@pytest.mark.parametrize("s,off,window", [(8, 0, None), (8, 0, 3),
                                          (8, 8, 5), (8, 16, 12),
                                          (6, 12, 4)])
def test_band_key_span_is_the_jax_tile_mask(s, off, window):
    """Each row's first and last live key are those of the JAX package's
    ``_tile_masks``; a row it masks whole has lo > hi."""
    keep = np.asarray(jax_tile_masks(s, s, off, True, window))
    lo, hi = fa.band_key_span(s, off, window)
    for i, row in enumerate(keep):
        if row.any():
            cols = np.flatnonzero(row)
            assert (lo[i].item(), hi[i].item()) == (cols[0], cols[-1])
            assert row[cols[0]:cols[-1] + 1].all()
        else:
            assert lo[i].item() > hi[i].item()


@pytest.mark.parametrize("case", BAND_CASES)
def test_band_fwd_plain_version_matches_jax_kernel(case):
    b, s, h, h_kv, d, off, window, block = BAND_CASES[case]
    q, k, v = _band_inputs(case, 0)[:3]
    want_out, want_lse = _band_tile_fwd(*map(jnp.asarray, (q, k, v)), off,
                                        window, block, True)
    before = fa.band_launches
    out, lse = fa.flash_band_fwd(*map(torch.from_numpy, (q, k, v)), off,
                                 window)
    assert fa.band_launches == before  # the plain version counts nothing
    assert out.dtype == torch.float32 and lse.shape == (b, h, s)
    live = _live_rows(s, off, window)
    want_out, want_lse = np.asarray(want_out), np.asarray(want_lse)
    np.testing.assert_allclose(out.numpy()[:, live], want_out[:, live],
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy()[..., live], want_lse[..., live],
                               atol=LSE_ATOL, rtol=0)
    assert np.isfinite(out.numpy()).all()
    assert (lse.numpy()[..., ~live] <= -1e29).all()
    assert (want_lse[..., ~live] <= -1e29).all()
    if "dead-rows" in case:
        assert not live.all()


@pytest.mark.parametrize("case", BAND_CASES)
def test_band_fwd_bf16_operands_stay_within_the_rounding_bound(case):
    """Live rows: p rounded to bf16 moves out by at most
    ``fwd_bf16_rounding_bound`` from the f32 plain version (plus 1e-6 of
    f32 summation noise) and from ``_band_fwd_kernel`` (plus its 2e-5),
    and lse not at all; rows with no live key keep lse <= -1e29 and a
    finite out. ``operand_dtype=None`` is the default's arithmetic."""
    b, s, h, h_kv, d, off, window, block = BAND_CASES[case]
    q, k, v = _band_inputs(case, 3)[:3]
    want_out, _ = _band_tile_fwd(*map(jnp.asarray, (q, k, v)), off, window,
                                 block, True)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    exact = fa.flash_band_fwd_reference(qt, kt, vt, off, window)
    none = fa.flash_band_fwd_reference(qt, kt, vt, off, window,
                                       operand_dtype=None)
    assert all(torch.equal(x, y) for x, y in zip(exact, none))
    out, lse = fa.flash_band_fwd_reference(qt, kt, vt, off, window,
                                           operand_dtype=torch.bfloat16)
    bound = fa.fwd_bf16_rounding_bound(qt, kt, vt, True, window, off)
    live = _live_rows(s, off, window)
    err = np.abs(out.numpy()[:, live] - exact[0].numpy()[:, live]).max()
    assert 0 < err <= bound + 1e-6, (err, bound)
    assert np.abs(out.numpy()[:, live]
                  - np.asarray(want_out)[:, live]).max() <= bound + OUT_ATOL
    np.testing.assert_allclose(lse.numpy()[..., live],
                               exact[1].numpy()[..., live], atol=OUT_ATOL,
                               rtol=0)
    assert np.isfinite(out.numpy()).all()
    assert (lse.numpy()[..., ~live] <= -1e29).all()


@pytest.mark.parametrize("d,expected", [(128, True), (64, True),
                                        (32, False)])
def test_forward_route_takes_the_rings_shard_views(d, expected):
    """The ring hands each tile q, k and v as ``chunk(dim=1)`` views of
    the whole sequence (strided, offset by whole shards): bf16 at D 64 or
    128 stays on the forward's tensor-core route, for every shard."""
    full = [torch.zeros(2, 4 * 96, h, d, dtype=torch.bfloat16)
            for h in (4, 2, 2)]
    shards = [_split(x, RingAxis.local(4)) for x in full]
    for q, k, v in zip(*shards):
        assert not q.is_contiguous()
        assert fa.tensor_core_route(q, k, v) is expected


@pytest.mark.parametrize("case", BAND_CASES)
def test_band_bwd_plain_versions_match_jax_kernels(case):
    """dq, dk, dv in f32 from a finite global lse (the band tile's merged
    with a diagonal tile's, as the ring merges them) and a delta."""
    b, s, h, h_kv, d, off, window, block = BAND_CASES[case]
    q, k, v, g, k2, v2, delta = _band_inputs(case, 1)
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    _, lse_band = fa.flash_band_fwd_reference(qt, kt, vt, off, window)
    _, lse_diag = fa.flash_attention_reference(
        qt, torch.from_numpy(k2), torch.from_numpy(v2), True, None)
    lse = torch.logaddexp(lse_band, lse_diag)
    want = _band_tile_bwd(*map(jnp.asarray, (q, k, v, g, lse.numpy(), delta)),
                          off, window, block, True)
    dt = torch.from_numpy(delta)
    got = (fa.flash_band_dq(qt, kt, vt, gt, lse, dt, off, window),
           *fa.flash_band_dkv(qt, kt, vt, gt, lse, dt, off, window))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


def test_band_window_clamp_reaches_off_plus_s():
    """A band tile's pairs are up to off + S - 1 apart, so the window the
    wrapper passes may be cut to off + S, never to S: at off 64, S 64, a
    window of 96 masks keys a window of 64 keeps. The static kernels
    still cut at S."""
    case = "off-S-window-ge-S-gqa4"
    b, s, h, h_kv, d, off, window, block = BAND_CASES[case]
    q, k, v = map(torch.from_numpy, _band_inputs(case, 2)[:3])
    assert window >= s
    _, _, tail = fa._kernel_args(q, k, v, True, window, off)
    assert tail == (fa._scale(d), off, window)
    assert fa._kernel_args(q, k, v, True, 10 ** 9, off)[2][2] == off + s
    assert fa._kernel_args(q, k, v, True, window)[2] == (fa._scale(d), 1, s)
    out, lse = fa.flash_band_fwd(q, k, v, off, window)
    want_out, want_lse = _band_tile_fwd(*(jnp.asarray(x.numpy())
                                          for x in (q, k, v)),
                                        off, window, block, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=LSE_ATOL, rtol=0)
    # the cut the parent made (window -> S) changes the answer here
    cut, _ = fa.flash_band_fwd_reference(q, k, v, off, s)
    assert (cut - out).abs().max().item() > 1e-2


def test_bwd_args_hold_the_dense_lse_they_point_to():
    """A strided lse or delta is copied to the dense (B, H, S) the kernels
    read, and the copy is among the operands returned, so the caller holds
    it until the launch is enqueued and its block cannot go to an output
    first."""
    q, k, v, do = (torch.zeros(2, 64, 4, 8) for _ in range(4))
    wide = torch.randn(2, 4, 4 * 64)
    lse, delta = wide.chunk(4, dim=2)[1], wide.chunk(4, dim=2)[2]
    assert not lse.is_contiguous()
    ops, sizes, _, tail = fa._bwd_args(q, k, v, do, lse, delta, True, None,
                                       64)
    assert sizes == (2, 64, 4, 4, 8) and tail[1] == 64
    for got, want in zip(ops[4:], (lse, delta)):
        assert got.is_contiguous() and torch.equal(got, want)
    assert fa._ptrs(ops) == [x.data_ptr() for x in ops]
    assert ops[0] is q and ops[3] is do


@pytest.mark.parametrize("window", [None, 12], ids=["no-window", "window12"])
def test_ring_backward_passes_each_tile_a_dense_lse(monkeypatch, window):
    """The ring hands every tile's backward its shard's lse as a dense
    tensor, so no launch copies a strided chunk."""
    seen = []
    dispatch = fa._tile_bwd_dispatch

    def record(q, k, v, g, lse, delta, *rest):
        seen.append((lse.is_contiguous(), delta.is_contiguous()))
        return dispatch(q, k, v, g, lse, delta, *rest)

    monkeypatch.setattr(fa, "_tile_bwd_dispatch", record)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in
               _arrays(8, (1, 32, 4, 8), (1, 32, 2, 8), (1, 32, 2, 8)))
    out = ring_attention(q, k, v, RingAxis.local(4), impl="flash",
                         window=window)
    out.sum().backward()
    # the diagonal tiles, then the live visiting tiles (3 + 2 + 1 without
    # a window, 3 + 2 with window 12 over 3 ring steps)
    assert len(seen) == 4 + (6 if window is None else 5)
    assert all(a and b for a, b in seen)


@functools.lru_cache(maxsize=None)
def _jax_ring(causal, window, impl, n=4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    return jax.jit(jax.shard_map(
        lambda a, b, c: jax_ring(a, b, c, "sp", causal=causal, impl=impl,
                                 window=window, interpret=True),
        mesh=mesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"),
        check_vma=False))


# (causal, window, H_kv) at B 1, S 32 (S_local 8), H 4, D 8: window 5 takes
# 2 ring steps, window 12 takes 3 of 4 (dK/dV come home with the extra
# shift), no window takes all 4.
RING_CASES = [(False, None, 4), (True, None, 2), (True, 5, 2), (True, 12, 2)]


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal,window,h_kv", RING_CASES,
                         ids=["noncausal-mha", "causal-gqa2",
                              "window5-gqa2", "window12-gqa2"])
def test_local_ring_matches_jax_ring(impl, causal, window, h_kv):
    b, s, h, d = 1, 32, 4, 8
    q, k, v, g = _arrays(3, (b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d),
                         (b, s, h, d))
    ring = _jax_ring(causal, window, impl)
    want_out = ring(q, k, v)
    want = jax.grad(lambda *x: (ring(*x) * g).sum(), argnums=(0, 1, 2))(
        q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    counts = (fa.launches, fa.band_launches)
    out = ring_attention(qt, kt, vt, RingAxis.local(4), causal=causal,
                         impl=impl, window=window)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                              (qt, kt, vt))
    assert (fa.launches, fa.band_launches) == counts
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=OUT_ATOL, rtol=0)
    for name, x, w in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=0, err_msg=f"d{name}")


def test_ring_steps_and_argument_checks():
    assert _ring_steps(4, 2048, True, 4096) == 3
    assert _ring_steps(4, 8, True, 12) == 3
    assert _ring_steps(4, 8, True, None) == _ring_steps(4, 8, False, None) == 4
    x = torch.zeros(1, 8, 2, 4)
    axis = RingAxis.local(2)
    with pytest.raises(ValueError, match="custom scale"):
        ring_attention(x, x, x, axis, impl="flash", scale=0.5)
    with pytest.raises(ValueError, match="unknown ring attention impl"):
        ring_attention(x, x, x, axis, impl="pallas")
    with pytest.raises(ValueError, match="window requires causal"):
        ring_attention(x, x, x, axis, causal=False, window=4)
    with pytest.raises(ValueError, match="window must be >= 1"):
        ring_attention(x, x, x, axis, window=0)
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(torch.zeros(1, 8, 3, 4), x, x, axis)
    with pytest.raises(ValueError, match="equal shards"):
        ring_attention(torch.zeros(1, 7, 2, 4), x, x, axis)
    with pytest.raises(TypeError, match="RingAxis"):
        ring_attention(x, x, x, "sp")
    with pytest.raises(ValueError, match="one shard a rank"):
        RingAxis(4, (0, 1))
    assert RingAxis.local(3).shift([[1], [2], [3]]) == [[3], [1], [2]]
    assert RingAxis.local(3).shift([[1], [2], [3]], hops=-1) == \
        [[2], [3], [1]]


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_ring_backward_saves_only_the_shards(impl):
    """The autograd node keeps q, k, v, out and lse and nothing per ring
    step, so per-shard backward memory is the same on a ring of 2 and of
    8 (tests/test_ring_attention.py::test_ring_backward_memory_constant
    holds the JAX package to the same)."""
    def saved_bytes_per_shard(n):
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in
                   _arrays(4, (1, 16 * n, 2, 8), (1, 16 * n, 2, 8),
                           (1, 16 * n, 2, 8)))
        out = ring_attention(q, k, v, RingAxis.local(n), impl=impl)
        saved = out.grad_fn.saved_tensors
        assert [tuple(t.shape) for t in saved] == [
            tuple(q.shape), tuple(k.shape), tuple(v.shape), tuple(out.shape),
            (1, 2, 16 * n)]
        return sum(t.numel() * t.element_size() for t in saved) / n

    assert saved_bytes_per_shard(8) == saved_bytes_per_shard(2)


MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=64, max_seq=32, attention_window=12)


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return out


@functools.lru_cache(maxsize=None)
def _jax_model_grads(impl, positional, remat):
    """(loss, {leaf: grad}) of the JAX loss_fn under shard_map over 4
    devices, and the numpy parameters it started from."""
    cfg = jtfm.TransformerConfig(dtype=jnp.float32, remat=remat,
                                 attention_impl=impl, positional=positional,
                                 flash_interpret=True, **MODEL)
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    tokens = np.random.default_rng(5).integers(0, 64, (2, 32))
    targets = np.roll(tokens, -1, axis=1)
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    axes = jtfm.ShardAxes(dp=None, sp="sp", tp=None)
    f = jax.jit(jax.shard_map(
        lambda p, t, y: jtfm.loss_fn(p, t, y, cfg, axes), mesh=mesh,
        in_specs=(jtfm.param_specs(cfg, axes), P(None, "sp"),
                  P(None, "sp")),
        out_specs=P(), check_vma=False))
    loss, grads = jax.value_and_grad(lambda p: f(p, tokens, targets))(params)
    return (float(loss), _flat(jax.tree.map(np.asarray, grads)),
            jax.tree.map(np.asarray, params), tokens, targets)


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off",
                                                      "remat-on"])
@pytest.mark.parametrize("impl,positional", [("dense", "learned"),
                                             ("flash", "rope")])
def test_sp_transformer_matches_jax_loss_fn(impl, positional, remat):
    want_loss, want, params, tokens, targets = _jax_model_grads(
        impl, positional, remat)
    cfg = tfm.TransformerConfig(dtype=torch.float32, remat=remat,
                                attention_impl=impl, positional=positional,
                                **MODEL)
    lm = tfm.TransformerLM(cfg, tfm.params_from_jax(params, cfg, "cpu"),
                           device="cpu",
                           axes=tfm.ShardAxes(sp=RingAxis.local(4)))
    loss = lm.loss(torch.from_numpy(tokens), torch.from_numpy(targets))
    loss.backward()
    assert abs(loss.item() - want_loss) <= MODEL_ATOL
    got = {k: p.grad for k, p in lm.top.items()}
    for i, layer in enumerate(lm.layers):
        got.update({f"layers.{i}.{k}": p.grad for k, p in layer.items()})
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, atol=MODEL_ATOL,
                                   rtol=MODEL_ATOL, err_msg=name)


def test_sp_transformer_matches_the_unsharded_model():
    """The local ring changes nothing but the attention's tiling: the
    sharded model's loss and logits equal the unsharded one's."""
    cfg = tfm.TransformerConfig(dtype=torch.float32, attention_impl="flash",
                                positional="rope", **MODEL)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 64,
                                                                (2, 32)))
    axes = tfm.ShardAxes(sp=RingAxis.local(4))
    np.testing.assert_allclose(
        tfm.forward(params, tokens, cfg, axes).detach().numpy(),
        tfm.forward(params, tokens, cfg).detach().numpy(), atol=1e-4,
        rtol=0)
    with pytest.raises(TypeError, match="axes.tp must be a process group"):
        tfm.loss_fn(params, tokens, tokens, cfg, tfm.ShardAxes(tp="tp"))
    with pytest.raises(NotImplementedError, match="DistributedOptimizer"):
        tfm.forward(params, tokens, cfg, tfm.ShardAxes(dp="dp"))
    with pytest.raises(TypeError, match="RingAxis"):
        tfm.forward(params, tokens, cfg, tfm.ShardAxes(sp="sp"))


def test_dense_attention_is_the_ring_baseline():
    """A ring of 1 is the plain dense attention."""
    q, k, v = map(torch.from_numpy, _arrays(7, (1, 16, 4, 8), (1, 16, 2, 8),
                                            (1, 16, 2, 8)))
    for impl in ("dense", "flash"):
        torch.testing.assert_close(
            ring_attention(q, k, v, RingAxis.local(1), impl=impl, window=5),
            dense_attention(q, k, v, window=5), atol=OUT_ATOL, rtol=0)
