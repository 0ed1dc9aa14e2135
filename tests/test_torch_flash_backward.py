"""The port's flash-attention backward against the JAX package's.

The same inputs, made with numpy, go through JAX's custom VJP of
``flash_attention`` / ``flash_attention_with_lse`` with the Pallas
kernels in interpret mode (``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` run
on the CPU, as tests/test_flash_attention.py runs them), and through the
port's autograd ``Function``, which on a CPU tensor computes the plain
versions of ``flash_bwd_dq`` and ``flash_bwd_dkv``. The cases take every
branch of the JAX backward: one block, several blocks (``block_size``
forced to 64 or 128), the ragged causal pad (lse padded to +1e30), the
ragged non-causal dense VJP, a sliding window, and GQA groups 1, 2 and
4. The plain versions are also held directly to ``_flash_bwd_impl``'s
outputs for the same (q, k, v, dO, lse, delta).

Tolerances: f32 gradients hold to atol 1e-4, the reference's band for
its kernels' gradients against dense attention
(tests/test_flash_attention.py:86); both sides compute in f32 and differ
in summation order only (observed below 1e-5). bf16 inputs run JAX's
bf16 kernels in interpret mode, and a bf16 gradient may differ by one
bf16 rounding of its largest magnitude (atol 2^-8 of it).

The tensor-core route's side, also on the CPU: the plain versions with
``operand_dtype=torch.bfloat16`` (P and dS rounded to bf16 before the
second products) stay within ``bf16_rounding_bound`` of the f32 ones,
and with ``operand_dtype=None`` are the reference's arithmetic; the
route's dispatch rule ``tensor_core_route`` as a pure function of the
operands; and the Python mirrors of the kernels' tile-skip bounds
(``dq_key_tiles``, ``dkv_query_tiles``) against the JAX package's
``_tile_masks`` and ``_band_live``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import (_band_live, _band_tile_bwd,
                                             _flash_bwd_impl, _flash_fwd_impl,
                                             flash_attention as jax_flash,
                                             flash_attention_with_lse
                                             as jax_flash_lse)
from horovod_tpu.parallel.ring_attention import _tile_masks as jax_tile_masks
from horovod_tpu_torch.ops import flash_attention as fa

F32_ATOL = 1e-4

# (B, S, H, H_kv, D, causal, window, block_size): the JAX branch in the id
CASES = {
    "one-block-causal-mha": (1, 128, 4, 4, 16, True, None, 512),
    "one-block-noncausal-gqa2": (2, 96, 4, 2, 16, False, None, 512),
    "multi-block-causal-gqa4": (1, 256, 4, 1, 8, True, None, 64),
    "multi-block-noncausal-gqa2": (1, 256, 4, 2, 8, False, None, 128),
    "ragged-causal-pad-gqa2": (1, 200, 4, 2, 16, True, None, 128),
    "ragged-noncausal-dense-gqa2": (1, 200, 4, 2, 16, False, None, 128),
    "window-multi-block-gqa2": (1, 256, 4, 2, 16, True, 40, 64),
    "window-ragged-pad-gqa4": (1, 200, 4, 1, 8, True, 50, 128),
}


def _inputs(case, seed):
    b, s, h, h_kv, d = CASES[case][:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d),
                          (b, s, h, d), (b, h, s))]


@functools.lru_cache(maxsize=None)
def _jax_vjp(causal, block, window, with_lse):
    """Jitted (q, k, v, g_out[, g_lse]) -> (dq, dk, dv) through JAX's
    custom VJP with the kernels in interpret mode."""
    def grads(q, k, v, g, g_lse):
        if with_lse:
            fn = lambda *x: jax_flash_lse(*x, causal, block, True, window)  # noqa: E731
            _, vjp = jax.vjp(fn, q, k, v)
            return vjp((g, g_lse))
        fn = lambda *x: jax_flash(*x, causal, block, True, window)  # noqa: E731
        _, vjp = jax.vjp(fn, q, k, v)
        return vjp(g)
    return jax.jit(grads)


def _port_grads(q, k, v, g, g_lse, causal, window, with_lse, dtype):
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(qt, kt, vt, causal, window)
    loss = (out.float() * torch.from_numpy(g).to(dtype).float()).sum()
    if with_lse:
        loss = loss + (lse * torch.from_numpy(g_lse)).sum()
    return torch.autograd.grad(loss, (qt, kt, vt))


def _bf16_atol(want):
    return 2.0 ** -8 * max(float(np.abs(want).max()), 1e-6)


# Every branch with the output cotangent alone, and one of each branch
# family (one block, several blocks, the pad, the dense VJP) with an lse
# cotangent as well.
VJP_CASES = [(case, False) for case in CASES] + [
    (case, True) for case in ("one-block-causal-mha",
                              "multi-block-noncausal-gqa2",
                              "ragged-causal-pad-gqa2",
                              "ragged-noncausal-dense-gqa2")]


@pytest.mark.parametrize(
    "case,with_lse", VJP_CASES,
    ids=[f"{c}-{'out+lse' if w else 'out'}" for c, w in VJP_CASES])
def test_plain_backward_matches_jax_vjp_f32(case, with_lse):
    b, s, h, h_kv, d, causal, window, block = CASES[case]
    q, k, v, g, g_lse = _inputs(case, seed=len(case))
    want = _jax_vjp(causal, block, window, with_lse)(q, k, v, g, g_lse)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    got = _port_grads(q, k, v, g, g_lse, causal, window, with_lse,
                      torch.float32)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before
    for name, x, w in zip("qkv", got, want):
        assert x.shape == w.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=F32_ATOL,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["multi-block-causal-gqa4",
                                  "window-multi-block-gqa2",
                                  "one-block-noncausal-gqa2"])
def test_plain_backward_matches_jax_kernels_bf16(case):
    b, s, h, h_kv, d, causal, window, block = CASES[case]
    q, k, v, g, g_lse = _inputs(case, seed=7)
    bf = [np.asarray(jnp.asarray(x).astype(jnp.bfloat16)) for x in (q, k, v, g)]
    want = _jax_vjp(causal, block, window, False)(*bf, g_lse)
    got = _port_grads(q, k, v, g, g_lse, causal, window, False,
                      torch.bfloat16)
    for name, x, w in zip("qkv", got, want):
        assert x.dtype == torch.bfloat16, name
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(x.float().numpy(), w, atol=_bf16_atol(w),
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["one-block-causal-mha",
                                  "multi-block-noncausal-gqa2",
                                  "ragged-causal-pad-gqa2",
                                  "window-ragged-pad-gqa4"])
def test_plain_versions_match_jax_bwd_impl(case):
    """flash_bwd_dq_reference / flash_bwd_dkv_reference against
    ``_flash_bwd_impl`` on the same (q, k, v, out, lse, dO), with an lse
    cotangent folded into delta as both packages fold it."""
    b, s, h, h_kv, d, causal, window, block = CASES[case]
    q, k, v, g, g_lse = _inputs(case, seed=3)
    out, lse = _flash_fwd_impl(*(jnp.asarray(x) for x in (q, k, v)), causal,
                               block, True, window)
    dq, dk, dv = _flash_bwd_impl(causal, block, True, jnp.asarray(q),
                                 jnp.asarray(k), jnp.asarray(v), out, lse,
                                 jnp.asarray(g), jnp.asarray(g_lse), window)
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    out_t = torch.from_numpy(np.array(out))
    lse_t = torch.from_numpy(np.array(lse).reshape(b, h, s))
    delta = (gt * out_t).sum(-1).transpose(1, 2) - torch.from_numpy(g_lse)
    got_dq = fa.flash_bwd_dq(qt, kt, vt, gt, lse_t, delta, causal, window)
    got_dk, got_dv = fa.flash_bwd_dkv(qt, kt, vt, gt, lse_t, delta, causal,
                                      window)
    for name, x, w in (("dq", got_dq, dq), ("dk", got_dk, dk),
                       ("dv", got_dv, dv)):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=F32_ATOL,
                                   rtol=0, err_msg=name)


def test_backward_rejects_mismatched_operands():
    q, k, v, g, g_lse = (torch.from_numpy(x)
                         for x in _inputs("one-block-causal-mha", 0))
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    with pytest.raises(ValueError, match="dO must match q"):
        fa.flash_bwd_dq(q, k, v, g.to(torch.bfloat16), lse, lse)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_bwd_dkv(q, k, v, g, lse[:, :, :5], lse)
    with pytest.raises(ValueError, match="delta must be"):
        fa.flash_bwd_dq(q, k, v, g, lse, lse.double())


def _tile_inputs(b, s, h, h_kv, d, seed):
    """f32 q, k, v, dO and a delta, made with numpy."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d),
                          (b, s, h, d), (b, h, s))]


# (B, S, H, H_kv, D, causal, window, off): off None for the static tiles
OPERAND_CASES = {
    "causal-gqa4": (1, 96, 4, 1, 16, True, None, None),
    "window-ragged-gqa2": (1, 77, 4, 2, 16, True, 20, None),
    "noncausal-mha": (2, 48, 2, 2, 8, False, None, None),
    "band-off-S-dead-rows-gqa2": (1, 64, 4, 2, 16, True, 40, 64),
    "band-off-2S-gqa2": (1, 64, 2, 1, 8, True, 100, 128),
}


def _operand_case(case, seed):
    """(args, extra, dq plain, dkv plain): inputs with the lse a forward
    (the band tile's merged with a diagonal tile's, as the ring merges
    them) gives, and the matching plain versions."""
    b, s, h, h_kv, d, causal, window, off = OPERAND_CASES[case]
    q, k, v, do, delta = _tile_inputs(b, s, h, h_kv, d, seed)
    if off is None:
        _, lse = fa.flash_attention_reference(q, k, v, causal, window)
        return ((q, k, v, do, lse, delta), (causal, window),
                fa.flash_bwd_dq_reference, fa.flash_bwd_dkv_reference)
    _, lse_band = fa.flash_band_fwd_reference(q, k, v, off, window)
    _, lse_diag = fa.flash_attention_reference(q, k, v, True, window)
    return ((q, k, v, do, torch.logaddexp(lse_band, lse_diag), delta),
            (off, window), fa.flash_band_dq_reference,
            fa.flash_band_dkv_reference)


@pytest.mark.parametrize("case", OPERAND_CASES)
def test_bf16_operands_stay_within_the_rounding_bound(case):
    """P and dS rounded to bf16 move each gradient by no more than
    ``bf16_rounding_bound`` (2^-8 of the sum over absolute values) plus
    f32 summation noise (1e-6), and do move it: the rounding happened."""
    args, extra, dq_ref, dkv_ref = _operand_case(case, 5)
    exact = (dq_ref(*args, *extra), *dkv_ref(*args, *extra))
    rounded = (dq_ref(*args, *extra, operand_dtype=torch.bfloat16),
               *dkv_ref(*args, *extra, operand_dtype=torch.bfloat16))
    causal, window, off = OPERAND_CASES[case][5:]
    bound = fa.bf16_rounding_bound(*args, causal, window, off or 0)
    for name, x, w, tol in zip(("dq", "dk", "dv"), rounded, exact, bound):
        err = (x - w).abs().max().item()
        assert 0 < err <= tol + 1e-6, (name, err, tol)


@pytest.mark.parametrize("case", ["causal-gqa4", "window-ragged-gqa2",
                                  "noncausal-mha"])
def test_static_plain_versions_default_to_the_reference_arithmetic(case):
    """``operand_dtype=None`` is the default and the reference's f32
    arithmetic: the same bits as the default call, and ``_flash_bwd_impl``
    (Pallas kernels in interpret mode) within 1e-4."""
    b, s, h, h_kv, d, causal, window, _ = OPERAND_CASES[case]
    q, k, v, g, g_lse = (x.numpy() for x in _tile_inputs(b, s, h, h_kv, d,
                                                         6))
    out, lse = _flash_fwd_impl(*(jnp.asarray(x) for x in (q, k, v)), causal,
                               128, True, window)
    want = _flash_bwd_impl(causal, 128, True, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v), out, lse, jnp.asarray(g),
                           jnp.asarray(g_lse), window)
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    lse_t = torch.from_numpy(np.array(lse).reshape(b, h, s))
    delta = (gt * torch.from_numpy(np.array(out))).sum(-1).transpose(1, 2) \
        - torch.from_numpy(g_lse)
    args = (qt, kt, vt, gt, lse_t, delta, causal, window)
    got = (fa.flash_bwd_dq_reference(*args, operand_dtype=None),
           *fa.flash_bwd_dkv_reference(*args, operand_dtype=None))
    default = (fa.flash_bwd_dq_reference(*args),
               *fa.flash_bwd_dkv_reference(*args))
    for name, x, y, w in zip(("dq", "dk", "dv"), got, default, want):
        assert torch.equal(x, y), name
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=F32_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("case", ["band-off-S-dead-rows-gqa2",
                                  "band-off-2S-gqa2"])
def test_band_plain_versions_default_to_the_reference_arithmetic(case):
    """The band plain versions with ``operand_dtype=None`` against
    ``_band_tile_bwd`` (Pallas band kernels in interpret mode)."""
    args, (off, window), dq_ref, dkv_ref = _operand_case(case, 7)
    want = _band_tile_bwd(*(jnp.asarray(x.numpy()) for x in args), off,
                          window, 64, True)
    got = (dq_ref(*args, off, window, operand_dtype=None),
           *dkv_ref(*args, off, window, operand_dtype=None))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=F32_ATOL,
                                   rtol=0, err_msg=name)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _misaligned(*shape):
    """A bf16 tensor whose base pointer sits 2 bytes past a 16-byte
    boundary."""
    flat = torch.zeros(int(np.prod(shape)) + 8, dtype=torch.bfloat16)
    start = (16 - flat.data_ptr() % 16) % 16 // 2 + 1
    return flat[start:start + int(np.prod(shape))].view(shape)


ROUTE_CASES = {  # name: (q, k, v, dO) maker, tensor-core route expected
    "bf16-d128": (lambda: (_bf16(1, 256, 4, 128), _bf16(1, 256, 2, 128),
                           _bf16(1, 256, 2, 128), _bf16(1, 256, 4, 128)),
                  True),
    "bf16-d64-mha": (lambda: [_bf16(2, 100, 4, 64) for _ in range(4)], True),
    "f32-d128": (lambda: [torch.zeros(1, 64, 2, 128) for _ in range(4)],
                 False),
    "bf16-d40": (lambda: [_bf16(1, 64, 2, 40) for _ in range(4)], False),
    "bf16-d96": (lambda: [_bf16(1, 64, 2, 96) for _ in range(4)], False),
    "bf16-d8": (lambda: [_bf16(1, 64, 2, 8) for _ in range(4)], False),
    "misaligned-k": (lambda: (_bf16(1, 64, 2, 64), _misaligned(1, 64, 2, 64),
                              _bf16(1, 64, 2, 64), _bf16(1, 64, 2, 64)),
                     False),
    "head-stride-132": (lambda: (_bf16(1, 64, 2, 132)[..., :128],
                                 *[_bf16(1, 64, 2, 128) for _ in range(3)]),
                        False),
    "transposed-bhsd": (lambda: [_bf16(1, 2, 64, 128).transpose(1, 2)
                                 for _ in range(4)], True),
}


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_tensor_core_route_rule(case):
    """dtype, head dim, base alignment and strides decide the route."""
    make, expected = ROUTE_CASES[case]
    assert fa.tensor_core_route(*make()) is expected


def test_tensor_core_route_ignores_the_stride_of_a_size_one_dim():
    """torch leaves the stride of a size-1 dimension arbitrary: at B 1
    autograd hands the backward a dO whose batch stride is 1. Such a
    stride is never stepped, so the kernels take the stride a dense
    layout gives it, and the route stays the tensor cores'."""
    q = _bf16(1, 64, 4, 64)
    do = torch.zeros(64 * 4 * 64, dtype=torch.bfloat16).as_strided(
        (1, 64, 4, 64), (1, 256, 64, 1))
    assert do.is_contiguous()
    assert fa._strides(do) == fa._strides(q) == [16384, 256, 64]
    assert fa.tensor_core_route(q, q, q, do)
    one_head = torch.zeros(64 * 64, dtype=torch.bfloat16).as_strided(
        (1, 64, 1, 64), (3, 64, 5, 1))
    assert fa._strides(one_head) == [4096, 64, 64]


@pytest.mark.parametrize("d,expected", [(128, True), (64, True), (40, False)])
def test_tensor_core_route_takes_the_rings_chunk_views(d, expected):
    """The ring passes q, k, v and dO as ``chunk(dim=1)`` views of the
    whole sequence: strided, offset by whole shards, and at D 64 or 128
    still on the tensor-core route."""
    full = [_bf16(2, 4 * 96, h, d) for h in (4, 2, 2, 4)]
    for i in range(4):
        shard = [x.chunk(4, dim=1)[i] for x in full]
        assert not shard[0].is_contiguous()
        assert fa.tensor_core_route(*shard) is expected


def _live_tiles(keep, rows, cols):
    """Whether the (rows, cols) block of a keep-mask (None: all) holds a
    live pair."""
    return True if keep is None else bool(keep[rows, cols].any())


TILE_CASES = [  # (s, off, causal, window)
    (300, 0, True, None), (300, 0, True, 100), (256, 0, False, None),
    (256, 256, True, 384), (200, 400, True, 300), (130, 130, True, 100),
    (192, 0, True, 1), (256, 512, True, 600), (128, 1000, True, 100),
]


@pytest.mark.parametrize("s,off,causal,window", TILE_CASES)
def test_dq_key_tiles_are_the_live_tiles(s, off, causal, window):
    """Each 64-row warpgroup's key tiles are exactly those where
    ``_tile_masks`` keeps a pair, and, where S is a multiple of the
    tile, those ``_band_live`` keeps at block 64."""
    keep = jax_tile_masks(s, s, off, causal, window)
    keep = None if keep is None else np.asarray(keep)
    n = -(-s // 64)
    for r0 in range(0, s, 64):
        lo, hi = fa.dq_key_tiles(r0, 64, s, off, causal, window)
        live = [t for t in range(n) if _live_tiles(
            keep, slice(r0, r0 + 64), slice(64 * t, 64 * t + 64))]
        assert list(range(lo, hi)) == live, (r0, lo, hi, live)
        if causal and s % 64 == 0:
            band = [t for t in range(n)
                    if bool(_band_live(off, r0 // 64, t, 64, window))]
            assert live == band


@pytest.mark.parametrize("s,off,causal,window", TILE_CASES)
def test_dkv_query_tiles_are_the_live_tiles(s, off, causal, window):
    """Each key tile's query tiles are exactly those where
    ``_tile_masks`` keeps a pair, and ``_band_live``'s where S is a
    multiple of the tile."""
    keep = jax_tile_masks(s, s, off, causal, window)
    keep = None if keep is None else np.asarray(keep)
    n = -(-s // 64)
    for k0 in range(0, s, 64):
        lo, hi = fa.dkv_query_tiles(k0, s, off, causal, window)
        live = [t for t in range(n) if _live_tiles(
            keep, slice(64 * t, 64 * t + 64), slice(k0, k0 + 64))]
        assert list(range(lo, hi)) == live, (k0, lo, hi, live)
        if causal and s % 64 == 0:
            band = [t for t in range(n)
                    if bool(_band_live(off, t, k0 // 64, 64, window))]
            assert live == band
