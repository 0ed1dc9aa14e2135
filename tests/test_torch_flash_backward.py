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
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import (_flash_bwd_impl, _flash_fwd_impl,
                                             flash_attention as jax_flash,
                                             flash_attention_with_lse
                                             as jax_flash_lse)
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
