"""The port's flash attention (horovod_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel.

The same inputs, made with numpy, go through JAX's ``_flash_fwd_impl``
in interpret mode (the Pallas ``_fwd_kernel`` run on the CPU, as
tests/test_flash_attention.py runs it) and through the port, which on a
CPU tensor computes the kernel's plain version. The cases take each
branch of the JAX wrapper: one block, several blocks (``block_size``
forced small), the ragged causal pad, and the ragged non-causal dense
fallback, with MHA and GQA groups 2 and 4, causal, non-causal and a
sliding window.

Tolerances: f32 holds O and lse to atol 2e-5, the reference's own band
for its kernel against dense attention (tests/test_flash_attention.py);
both sides compute in f32 and differ only in summation order. A bf16
output may differ by one bf16 rounding of a value below 2 (2^-7), so
bf16 O holds to atol 1e-2; its lse is f32 and keeps 2e-5.

The tensor-core route's side, also on the CPU: the plain version with
``operand_dtype=torch.bfloat16`` (scores ``(q.k^T)*scale``, p rounded to
bf16 before ``p.v``, l from the f32 p) stays within
``fwd_bf16_rounding_bound`` of the f32 plain version and of the JAX
kernel (plus 2e-5, or one bf16 ulp of the output for bf16 inputs), and
with ``operand_dtype=None`` is the reference's arithmetic bit for bit;
the route rule ``tensor_core_route`` without dO takes the model's
``kv[:, :, 1]`` views.

The launch checks take any head dim and B*H past 65535, and at D 256
(the CUDA-core loop's widest tiles on the card) and at D 320 and 512
(the loop's 256-column pieces) the plain forward and backward, static
and band, hold to the Pallas kernels in interpret mode at the
reference's own bands (2e-5 on out and lse, 5e-5 on the gradients).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from horovod_tpu.ops.flash_attention import (
    _flash_fwd_impl, flash_attention as jax_flash,
    paged_attention_decode as jax_paged_decode)
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import flash_attention as fa

F32_ATOL = 2e-5
BF16_ATOL = 1e-2


def _qkv(shape, h_kv, seed):
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, h_kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, h_kv, d), dtype=np.float32)
    return q, k, v


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


# (B, S, H, H_kv, D, causal, window, block_size): the JAX branch in the id
CASES = {
    "one-block-causal-mha": (2, 128, 4, 4, 16, True, None, 512),
    "one-block-noncausal-gqa2": (2, 96, 4, 2, 16, False, None, 512),
    "multi-block-causal-gqa4": (1, 256, 4, 1, 8, True, None, 128),
    "multi-block-noncausal-gqa2": (1, 256, 4, 2, 8, False, None, 128),
    "ragged-causal-pad-gqa2": (1, 200, 4, 2, 16, True, None, 128),
    "ragged-noncausal-dense-gqa2": (1, 200, 4, 2, 16, False, None, 128),
    "window-multi-block-gqa2": (1, 256, 4, 2, 16, True, 40, 128),
    "window-one-block-mha": (2, 96, 4, 4, 8, True, 16, 512),
    "window-ragged-pad-gqa4": (1, 200, 4, 1, 8, True, 50, 128),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_jax_kernel_f32(case):
    b, s, h, h_kv, d, causal, window, block = CASES[case]
    q, k, v = _qkv((b, s, h, d), h_kv, seed=len(case))
    out, lse = _flash_fwd_impl(_jax(q, jnp.float32), _jax(k, jnp.float32),
                               _jax(v, jnp.float32), causal, block, True,
                               window)
    got_o, got_lse = fa.flash_attention_with_lse(
        _torch(q, torch.float32), _torch(k, torch.float32),
        _torch(v, torch.float32), causal, window)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(out),
                               atol=F32_ATOL, rtol=0)
    assert got_lse.shape == (b, h, s)
    if lse is None:
        # JAX's ragged non-causal branch runs dense and has no lse
        assert case.startswith("ragged-noncausal")
    else:
        np.testing.assert_allclose(got_lse.numpy(),
                                   np.asarray(lse).reshape(b, h, s),
                                   atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["multi-block-causal-gqa4",
                                  "window-multi-block-gqa2"])
def test_reference_matches_jax_kernel_bf16(case):
    b, s, h, h_kv, d, causal, window, block = CASES[case]
    q, k, v = _qkv((b, s, h, d), h_kv, seed=7)
    out, lse = _flash_fwd_impl(_jax(q, jnp.bfloat16), _jax(k, jnp.bfloat16),
                               _jax(v, jnp.bfloat16), causal, block, True,
                               window)
    got_o, got_lse = fa.flash_attention_with_lse(
        _torch(q, torch.bfloat16), _torch(k, torch.bfloat16),
        _torch(v, torch.bfloat16), causal, window)
    assert got_o.dtype == torch.bfloat16
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(out.astype(jnp.float32)),
                               atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse).reshape(b, h, s),
                               atol=F32_ATOL, rtol=0)


def test_cpu_call_runs_plain_version_without_launching():
    q, k, v = _qkv((1, 64, 4, 8), 2, seed=3)
    before = fa.launches
    out = fa.flash_attention(_torch(q, torch.float32),
                             _torch(k, torch.float32),
                             _torch(v, torch.float32))
    ref, _ = fa.flash_attention_reference(_torch(q, torch.float32),
                                          _torch(k, torch.float32),
                                          _torch(v, torch.float32))
    assert fa.launches == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["window-noncausal", "window-zero",
                                 "dtype-mix", "gqa-indivisible",
                                 "meta-device"])
def test_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (_torch(x, torch.float32)
               for x in _qkv((1, 16, 4, 8), 2, seed=0))
    kw = {}
    if bad == "window-noncausal":
        kw, err = dict(causal=False, window=4), ValueError
    elif bad == "window-zero":
        kw, err = dict(window=0), ValueError
    elif bad == "dtype-mix":
        k, err = k.to(torch.bfloat16), TypeError
    elif bad == "gqa-indivisible":
        q, err = torch.zeros(1, 16, 3, 8), ValueError
    else:
        q, k, v = (x.to("meta") for x in (q, k, v))
        err = ValueError
    with pytest.raises(err):
        fa.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h_kv", [4, 2])
def test_paged_decode_matches_jax(dtype, h_kv):
    """One shared pool and page table through both packages; the null
    page 0 holds finite garbage that the length mask must keep out."""
    rng = np.random.default_rng(5)
    b, h, d, page, n_pages = 3, 4, 8, 4, 12
    q = rng.standard_normal((b, 1, h, d), dtype=np.float32)
    kp = rng.standard_normal((n_pages, page, h_kv, d), dtype=np.float32)
    vp = rng.standard_normal((n_pages, page, h_kv, d), dtype=np.float32)
    table = np.array([[3, 7, 0], [1, 2, 5], [9, 0, 0]], np.int32)
    lengths = np.array([6, 11, 2], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_paged_decode(_jax(q, jd), _jax(kp, jd), _jax(vp, jd),
                            jnp.asarray(table), jnp.asarray(lengths))
    got = fa.paged_attention_decode(
        _torch(q, td), _torch(kp, td), _torch(vp, td),
        torch.from_numpy(table).long(), torch.from_numpy(lengths).long())
    assert got.shape == (b, 1, h, d) and got.dtype == td
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        atol=F32_ATOL if dtype == "float32" else BF16_ATOL, rtol=0)


# the tensor-core route's rounding against the f32 reference and the JAX
# kernel: causal, windowed, non-causal, GQA 1/2/4 and ragged cases
OPERAND_CASES = ["one-block-causal-mha", "multi-block-causal-gqa4",
                 "multi-block-noncausal-gqa2", "ragged-causal-pad-gqa2",
                 "ragged-noncausal-dense-gqa2", "window-multi-block-gqa2",
                 "window-ragged-pad-gqa4"]


@functools.lru_cache(maxsize=None)
def _jax_fwd(case, dtype):
    """(inputs, JAX kernel out as f32 numpy) of ``case`` in ``dtype``."""
    b, s, h, h_kv, d, causal, window, block = CASES[case]
    q, k, v = _qkv((b, s, h, d), h_kv, seed=len(case) + 100)
    jd = getattr(jnp, dtype)
    out, _ = _flash_fwd_impl(_jax(q, jd), _jax(k, jd), _jax(v, jd), causal,
                             block, True, window)
    return (q, k, v), np.asarray(out.astype(jnp.float32))


def _old_fwd_math(q, k, v, causal, window):
    """The plain forward as the parent tree computed it, written out:
    f32 ``(q*scale).k^T``, the -1e30 fill, p in f32, l clamped."""
    group = q.shape[2] // k.shape[2]
    qf = q.float() * fa._scale(q.shape[3])
    kf, vf = (x.float().repeat_interleave(group, dim=2) for x in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if causal:
        pos = torch.arange(q.shape[1])
        dist = pos[:, None] - pos[None, :]
        keep = dist >= 0
        if window is not None:
            keep = keep & (dist < window)
        sc = torch.where(keep, sc, -1e30)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["multi-block-causal-gqa4",
                                  "window-ragged-pad-gqa4",
                                  "ragged-noncausal-dense-gqa2"])
def test_operand_dtype_none_is_the_reference_arithmetic(case, dtype):
    """``operand_dtype=None`` (the default, and what every wrapper's CPU
    path runs) gives the parent's plain outputs bit for bit."""
    b, s, h, h_kv, d, causal, window, _ = CASES[case]
    td = getattr(torch, dtype)
    q, k, v = (_torch(x, td) for x in _qkv((b, s, h, d), h_kv, seed=9))
    got = fa.flash_attention_reference(q, k, v, causal, window,
                                       operand_dtype=None)
    default = fa.flash_attention_reference(q, k, v, causal, window)
    old = _old_fwd_math(q, k, v, causal, window)
    for x, y, z in zip(got, default, old):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("case", OPERAND_CASES)
def test_bf16_operands_stay_within_the_fwd_rounding_bound(case):
    """p rounded to bf16 moves out by no more than
    ``fwd_bf16_rounding_bound`` from the f32 plain version (plus f32
    summation noise, 1e-6) and from the JAX kernel in interpret mode
    (plus its own 2e-5 band), and does move it; lse does not move."""
    b, s, h, h_kv, d, causal, window, _ = CASES[case]
    (q, k, v), want = _jax_fwd(case, "float32")
    q, k, v = (_torch(x, torch.float32) for x in (q, k, v))
    exact, exact_lse = fa.flash_attention_reference(q, k, v, causal, window)
    out, lse = fa.flash_attention_reference(q, k, v, causal, window,
                                            operand_dtype=torch.bfloat16)
    bound = fa.fwd_bf16_rounding_bound(q, k, v, causal, window)
    err = (out - exact).abs().max().item()
    assert 0 < err <= bound + 1e-6, (err, bound)
    assert (out.numpy() - want).__abs__().max() <= bound + F32_ATOL
    np.testing.assert_allclose(lse.numpy(), exact_lse.numpy(),
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["multi-block-causal-gqa4",
                                  "window-multi-block-gqa2"])
def test_bf16_operands_on_bf16_inputs_stay_near_the_jax_kernel(case):
    """bf16 inputs, as the route takes them: the bf16-operand plain
    version's bf16 out lies within the bound plus one bf16 ulp of the
    largest output (each side rounds its output once) of the JAX bf16
    kernel's."""
    b, s, h, h_kv, d, causal, window, _ = CASES[case]
    (q, k, v), want = _jax_fwd(case, "bfloat16")
    q, k, v = (_torch(x, torch.bfloat16) for x in (q, k, v))
    out, _ = fa.flash_attention_reference(q, k, v, causal, window,
                                          operand_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    bound = fa.fwd_bf16_rounding_bound(q, k, v, causal, window)
    tol = bound + 2.0 ** -7 * np.abs(want).max()
    assert np.abs(out.float().numpy() - want).max() <= tol


def _misaligned(*shape):
    """A bf16 tensor whose base pointer sits 2 bytes past a 16-byte
    boundary."""
    flat = torch.zeros(int(np.prod(shape)) + 8, dtype=torch.bfloat16)
    start = (16 - flat.data_ptr() % 16) % 16 // 2 + 1
    return flat[start:start + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("head_dim,dtype,expected", [
    (128, torch.bfloat16, True), (64, torch.bfloat16, True),
    (64, torch.float32, False), (32, torch.bfloat16, False),
    (96, torch.bfloat16, False)])
def test_forward_route_takes_the_models_kv_views(head_dim, dtype, expected):
    """The model's q, k and v as ``_qkv_proj`` makes them (k and v the
    views ``kv[:, :, 0]`` and ``kv[:, :, 1]``, S stride 2*H_kv*D): bf16
    at D 64 or 128 takes the tensor cores, f32 and other head dims the
    loop."""
    cfg = tfm.TransformerConfig(vocab_size=64, d_model=4 * head_dim,
                                n_heads=4, n_kv_heads=2, n_layers=1,
                                d_ff=64, max_seq=32, dtype=dtype)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    h = torch.randn(2, 24, cfg.d_model)
    q, k, v = tfm._qkv_proj(params["layers"][0], h, cfg)
    assert v.stride(1) == 2 * 2 * head_dim and not v.is_contiguous()
    assert fa.tensor_core_route(q, k, v) is expected


@pytest.mark.parametrize("bad", ["misaligned-v", "head-stride-132",
                                 "odd-seq-stride"])
def test_forward_route_rejects_what_tma_cannot_read(bad):
    """A base pointer off 16 bytes or a stride off 8 elements takes the
    loop, for the forward (no dO) as for the backward."""
    q, k, v = (torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
               for _ in range(3))
    assert fa.tensor_core_route(q, k, v)
    if bad == "misaligned-v":
        v = _misaligned(1, 64, 2, 128)
    elif bad == "head-stride-132":
        k = torch.zeros(1, 64, 2, 132, dtype=torch.bfloat16)[..., :128]
    else:
        q = torch.zeros(64 * 260, dtype=torch.bfloat16).as_strided(
            (1, 64, 2, 128), (64 * 260, 260, 128, 1))
    assert not fa.tensor_core_route(q, k, v)


def test_kernel_args_take_head_dim_256_and_any_batch_times_heads():
    """The launch checks: head dim 256 and above (the CUDA-core loop
    holds a head dim above 256 in 256-column pieces), no head dim below
    1, and B*H past 65535 (every kernel puts B*H on grid.x). Shapes and
    strides are all that is read, so expanded views stand in."""
    q = torch.empty(1, 1, 1, 256).expand(4096, 64, 16, 256)
    sizes, strides, tail = fa._kernel_args(q, q, q, True, None)
    assert sizes == (4096, 64, 16, 16, 256) and sizes[0] * sizes[2] == 65536
    assert tail[0] == pytest.approx(256 ** -0.5)
    for d in (257, 320, 512):
        sizes, _, tail = fa._kernel_args(*(torch.empty(1, 8, 2, d),) * 3,
                                         True, None)
        assert sizes[-1] == d and tail[0] == pytest.approx(d ** -0.5)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        fa._kernel_args(*(torch.empty(1, 8, 2, 0),) * 3, True, None)


# The reference's bands for its kernels against dense attention
# (tests/test_flash_attention.py:22, :52): 2e-5 on out, 5e-5 on the
# gradients; f32 on both sides.
D256_CASES = {  # (B, S, H, H_kv, causal, window, block_size)
    "causal-gqa2": (1, 256, 4, 2, True, None, 128),
    "noncausal-mha": (1, 128, 2, 2, False, None, 128),
    "window-gqa4": (1, 256, 4, 1, True, 40, 128),
}


@pytest.mark.parametrize("case", list(D256_CASES))
def test_plain_versions_match_jax_kernels_at_head_dim_256(case):
    """Forward and backward of the plain versions at D 256, the card's
    new loop shape, against the Pallas kernels in interpret mode."""
    b, s, h, h_kv, causal, window, block = D256_CASES[case]
    q, k, v = _qkv((b, s, h, 256), h_kv, seed=11)
    g = np.random.default_rng(12).standard_normal((b, s, h, 256),
                                                  dtype=np.float32)
    out, lse = _flash_fwd_impl(*(jnp.asarray(x) for x in (q, k, v)),
                               causal, block, True, window)
    _, vjp = jax.vjp(lambda *x: jax_flash(*x, causal, block, True, window),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got_o, got_lse = fa.flash_attention_with_lse(qt, kt, vt, causal, window)
    np.testing.assert_allclose(got_o.detach().numpy(), np.asarray(out),
                               atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.detach().numpy(),
                               np.asarray(lse).reshape(b, h, s),
                               atol=F32_ATOL, rtol=0)
    got_grads = torch.autograd.grad(got_o, (qt, kt, vt),
                                    torch.from_numpy(g))
    for name, x, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=0, err_msg=f"d{name}")


# Head dims above 256: the loop's 256-column pieces on the card. The
# plain versions against the Pallas kernels in interpret mode, at the
# reference's bands; (B, S, H, H_kv, causal, window, block_size).
WIDE_CASES = {
    "causal-gqa2": (1, 128, 2, 1, True, None, 128),
    "window-gqa2": (1, 128, 2, 1, True, 40, 64),
}


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_plain_versions_match_jax_kernels_above_head_dim_256(case, d):
    """Static forward and backward at D 320 and 512."""
    b, s, h, h_kv, causal, window, block = WIDE_CASES[case]
    q, k, v = _qkv((b, s, h, d), h_kv, seed=13)
    g = np.random.default_rng(14).standard_normal((b, s, h, d),
                                                  dtype=np.float32)
    out, lse = _flash_fwd_impl(*(jnp.asarray(x) for x in (q, k, v)),
                               causal, block, True, window)
    _, vjp = jax.vjp(lambda *x: jax_flash(*x, causal, block, True, window),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got_o, got_lse = fa.flash_attention_with_lse(qt, kt, vt, causal, window)
    np.testing.assert_allclose(got_o.detach().numpy(), np.asarray(out),
                               atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.detach().numpy(),
                               np.asarray(lse).reshape(b, h, s),
                               atol=F32_ATOL, rtol=0)
    got_grads = torch.autograd.grad(got_o, (qt, kt, vt),
                                    torch.from_numpy(g))
    for name, x, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("d", [320, 512])
def test_band_plain_versions_match_jax_kernels_above_head_dim_256(d):
    """Band forward and backward at D 320 and 512, at the offset of the
    next shard (every row live under the window)."""
    from horovod_tpu.ops.flash_attention import (_band_tile_bwd,
                                                 _band_tile_fwd)
    b, s, h, h_kv, off, window = 1, 64, 2, 1, 64, 96
    q, k, v = _qkv((b, s, h, d), h_kv, seed=15)
    rng = np.random.default_rng(16)
    g = rng.standard_normal((b, s, h, d), dtype=np.float32)
    want_out, want_lse = _band_tile_fwd(*map(jnp.asarray, (q, k, v)), off,
                                        window, 64, True)
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    out, lse = fa.flash_band_fwd(qt, kt, vt, off, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=F32_ATOL, rtol=0)
    delta = (gt * out).sum(-1).transpose(1, 2).contiguous()
    args = (qt, kt, vt, gt, lse, delta)
    want = _band_tile_bwd(*(jnp.asarray(x.numpy()) for x in args), off,
                          window, 64, True)
    got = (fa.flash_band_dq_reference(*args, off, window),
           *fa.flash_band_dkv_reference(*args, off, window))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=0, err_msg=name)
