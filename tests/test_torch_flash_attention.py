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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import (
    _flash_fwd_impl, paged_attention_decode as jax_paged_decode)
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
