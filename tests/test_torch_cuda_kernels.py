"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one. The module
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; there, skip tests/conftest.py (which sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 outputs differ from the plain version by summation
order only (atol 2e-5); a bf16 output by at most one bf16 rounding of a
value below 4 (atol 2e-2); lse is f32 on both sides (atol 1e-4). A band
tile's row with no live key is compared by its contract (finite out,
lse <= -1e29), not by value: its out is a mean over the V rows each side
happened to visit.
Gradients are sums over a whole row or column of the score matrix, so
f32 gradients hold to 1e-4 and bf16 ones to one bf16 rounding (ulp) of
their largest magnitude (2^-7 of it, relative): both sides round an f32
value once, and values that straddle a rounding boundary land one ulp
apart. The band kernels' gradients are f32 for either input type, so
on the CUDA-core loop they hold to 1e-4.

The tensor-core route (bf16, D 64 or 128: ``fa.tensor_core_route``)
rounds P to bf16 before ``P.V`` in the forward. Its out is held to the
plain version run with ``operand_dtype=torch.bfloat16`` at the same
bands as above (2e-2 out, 1e-4 lse), and to the f32 plain version within
``fa.fwd_bf16_rounding_bound`` (2^-8 of ``sum p |v| / l``) plus, element
by element, half a bf16 ulp (2^-8 of the value) for the output's own
rounding. In the
backward it rounds P and dS to bf16 before the second products. Its
gradients are
held to the plain version run with ``operand_dtype=torch.bfloat16``, which
rounds them likewise: one bf16 ulp (2^-7) of the largest magnitude, for
the band kernels' f32 gradients too, since a P or dS value that
straddles a rounding boundary after an f32 summation in another order
moves its terms by an ulp. And to the f32 plain version within
``fa.bf16_rounding_bound`` (2^-8 of the sum over absolute values) plus
that ulp for a bf16 gradient, or 1e-4 for an f32 one.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_ATOL = 1e-4
GRAD_ATOL = 1e-4
BF16_ULP = 2.0 ** -7
# a bf16 output's own rounding: half an ulp, at most 2^-8 of its value
OUT_ROUNDING = 2.0 ** -8
# each kernel's launch counter on the loop and on the tensor cores
ROUTE_COUNTERS = {
    "flash_fwd": ("launches", "wgmma_launches"),
    "flash_band_fwd": ("band_launches", "band_wgmma_launches"),
    "flash_bwd_dq": ("dq_launches", "dq_wgmma_launches"),
    "flash_bwd_dkv": ("dkv_launches", "dkv_wgmma_launches"),
    "flash_band_dq": ("band_dq_launches", "band_dq_wgmma_launches"),
    "flash_band_dkv": ("band_dkv_launches", "band_dkv_wgmma_launches"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel does not run on "
                    "the CPU")
    return torch.device("cuda")


def _fwd_inputs(card, dtype, b, s, h, h_kv, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(card, dtype)
            for shape in ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d))]


def _assert_fwd_route_close(out, lse, args, extra, ref, tc, bound_args,
                            rows=None):
    """Hold a forward kernel's (out, lse) to its route's plain version
    (module docstring), on ``rows`` of the sequence (None: all)."""
    rows = slice(None) if rows is None else rows
    dtype = str(args[0].dtype)[len("torch."):]
    want, want_lse = ref(*args, *extra,
                         operand_dtype=torch.bfloat16 if tc else None)
    torch.testing.assert_close(out[:, rows].float(), want[:, rows].float(),
                               atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse[:, :, rows], want_lse[:, :, rows],
                               atol=LSE_ATOL, rtol=0)
    if not tc:
        return
    exact, _ = ref(*args, *extra)
    exact = exact[:, rows].float()
    # p's rounding moves the unrounded out by at most the bound, and the
    # output's rounding moves that value by at most OUT_ROUNDING of it
    bound = fa.fwd_bf16_rounding_bound(*args, *bound_args)
    torch.testing.assert_close(out[:, rows].float(), exact,
                               atol=(1 + OUT_ROUNDING) * bound,
                               rtol=OUT_ROUNDING)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,h_kv,d,causal,window", [
    (1, 256, 4, 1, 8, True, None),       # GQA 4, several kv tiles
    (1, 200, 4, 2, 16, False, None),     # ragged, non-causal
    (1, 200, 4, 1, 8, True, 50),         # ragged, window
    (2, 64, 16, 4, 128, True, None),     # the flagship head width
    # bf16 here takes the tensor cores
    (1, 1000, 8, 1, 64, True, None),     # ragged, GQA 8, D 64
    (1, 1000, 4, 2, 128, True, 256),     # ragged, window, GQA 2
    (2, 300, 4, 4, 128, False, None),    # non-causal, MHA
    (1, 512, 16, 4, 64, True, 100),      # window, GQA 4, D 64
    (1, 10, 4, 2, 128, True, None),      # shorter than one tile
    (2, 70, 2, 2, 64, False, None),      # one tile and a ragged edge
    (1, 200, 4, 2, 128, True, 1),        # window 1: each row its own key
])
def test_flash_fwd_matches_plain_version(card, dtype, b, s, h, h_kv, d,
                                         causal, window):
    td = getattr(torch, dtype)
    q, k, v = _fwd_inputs(card, td, b, s, h, h_kv, d, s + d)
    tc = fa.tensor_core_route(q, k, v)
    assert tc == (td == torch.bfloat16 and d in (64, 128))
    names = [("flash_fwd", False), ("flash_fwd", True)]
    n0 = _counts(names)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert _counts(names) == [n0[0] + (not tc), n0[1] + tc]
    assert out.dtype == td and lse.dtype == torch.float32
    _assert_fwd_route_close(out, lse, (q, k, v), (causal, window),
                            fa.flash_attention_reference, tc,
                            (causal, window))


@pytest.mark.cuda
def test_flash_fwd_takes_the_models_and_the_rings_views(card):
    """The model passes v as the view ``kv[:, :, 1]`` (S stride
    2*H_kv*D) and the ring passes ``chunk(dim=1)`` views: the tensor-core
    route reads them through their real strides, and gives what the same
    values made dense give."""
    rng = np.random.default_rng(21)
    b, s, h, h_kv, d = 2, 4 * 192, 8, 2, 128
    q = torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32)) \
        .to(card, torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal((b, s, 2, h_kv, d),
                                              np.float32)) \
        .to(card, torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    for args in ((q, k, v), [x.chunk(4, dim=1)[2] for x in (q, k, v)]):
        assert not args[2].is_contiguous()
        assert fa.tensor_core_route(*args)
        before = fa.wgmma_launches
        out, lse = fa.flash_attention_with_lse(*args, True, 300)
        band_out, band_lse = fa.flash_band_fwd(*args, 192, 300)
        dense = [x.contiguous() for x in args]
        want, want_lse = fa.flash_attention_with_lse(*dense, True, 300)
        band_want, band_want_lse = fa.flash_band_fwd(*dense, 192, 300)
        torch.cuda.synchronize()
        assert fa.wgmma_launches == before + 2
        assert torch.equal(out, want) and torch.equal(lse, want_lse)
        assert torch.equal(band_out, band_want)
        assert torch.equal(band_lse, band_want_lse)
        _assert_fwd_route_close(out, lse, args, (True, 300),
                                fa.flash_attention_reference, True,
                                (True, 300))


@pytest.mark.cuda
def test_static_kernels_take_ulysses_head_slices(card):
    """A local Ulysses shard (parallel/ulysses.py): q, k and v are head
    slices of the model's projections, H 4 / H_kv 1 out of H 16 / H_kv
    4, k and v views of ``kv[:, :, c]``, their base pointers j*(H/n)*D
    elements on. Each static kernel, forward and backward (dO the dense
    gradient autograd hands over), takes the tensor cores on every slice
    and gives what the same values made dense give, within the bands of
    its plain version."""
    rng = np.random.default_rng(23)
    b, s, h, h_kv, d, n, window = 1, 640, 16, 4, 128, 4, 256

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
            .to(card, torch.bfloat16)

    q, kv, do = draw((b, s, h, d)), draw((b, s, 2, h_kv, d)), \
        draw((b, s, h // n, d))
    hq, hk = h // n, h_kv // n
    for j in range(n):
        args = (q[:, :, j * hq:(j + 1) * hq], kv[:, :, 0, j * hk:(j + 1) * hk],
                kv[:, :, 1, j * hk:(j + 1) * hk])
        assert args[0].data_ptr() == q.data_ptr() + j * hq * d * 2
        assert fa.tensor_core_route(*args, do)
        dense = [x.contiguous() for x in args]
        names = [("flash_fwd", True), ("flash_bwd_dq", True),
                 ("flash_bwd_dkv", True)]
        n0 = _counts(names)
        out, lse = fa.flash_attention_with_lse(*args, True, window)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = fa.flash_bwd_dq(*args, do, lse, delta, True, window)
        dk, dv = fa.flash_bwd_dkv(*args, do, lse, delta, True, window)
        torch.cuda.synchronize()
        assert _counts(names) == [c + 1 for c in n0]
        want, want_lse = fa.flash_attention_with_lse(*dense, True, window)
        assert torch.equal(out, want) and torch.equal(lse, want_lse)
        assert torch.equal(dq, fa.flash_bwd_dq(*dense, do, lse, delta, True,
                                               window))
        for g, w in zip((dk, dv), fa.flash_bwd_dkv(*dense, do, lse, delta,
                                                   True, window)):
            assert torch.equal(g, w)
        _assert_fwd_route_close(out, lse, args, (True, window),
                                fa.flash_attention_reference, True,
                                (True, window))
        _assert_route_close((dq, dk, dv), (*args, do, lse, delta),
                            (True, window), (fa.flash_bwd_dq_reference,
                                             fa.flash_bwd_dkv_reference),
                            True, (True, window))


@pytest.mark.cuda
def test_flash_fwd_rejects_a_strided_head_dim(card):
    q = torch.zeros(1, 16, 2, 16, device=card)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


def _bwd_inputs(card, dtype, b, s, h, h_kv, d, causal, window, seed):
    """q, k, v, dO in ``dtype`` and the forward's lse and delta."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(card, dtype) for shape in ((b, s, h, d), (b, s, h_kv, d),
                                                  (b, s, h_kv, d), (b, s, h, d)))
    out, lse = fa.flash_attention_reference(q, k, v, causal, window)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _assert_grad_close(got, want, dtype):
    if dtype == torch.float32:
        atol = GRAD_ATOL
    else:
        atol = BF16_ULP * max(want.float().abs().max().item(), 1e-6)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def _counts(names):
    return [getattr(fa, ROUTE_COUNTERS[n][tc]) for n, tc in names]


def _assert_route_close(got, args, extra, refs, tc, bound_args):
    """Hold gradients to their route's plain versions (module docstring):
    ``refs`` the plain functions, ``bound_args`` the arguments of
    ``bf16_rounding_bound`` after the operands."""
    band = got[0].dtype == torch.float32 and args[0].dtype == torch.bfloat16
    operand = torch.bfloat16 if tc else None
    want = [w for ref in refs for w in _tuple(ref(*args, *extra,
                                                  operand_dtype=operand))]
    for g, w in zip(got, want):
        if tc and band:
            atol = BF16_ULP * max(w.abs().max().item(), 1e-6)
            torch.testing.assert_close(g, w, atol=atol, rtol=0)
        else:
            _assert_grad_close(g, w, args[0].dtype if not band else
                               torch.float32)
    if not tc:
        return
    exact = [w for ref in refs for w in _tuple(ref(*args, *extra))]
    bound = fa.bf16_rounding_bound(*args, *bound_args)
    for g, w, tol in zip(got, exact, bound):
        extra_tol = GRAD_ATOL if g.dtype == torch.float32 else \
            BF16_ULP * w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), atol=tol + extra_tol,
                                   rtol=0)


def _tuple(x):
    return (x,) if torch.is_tensor(x) else tuple(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,h_kv,d,causal,window", [
    (1, 256, 4, 1, 8, True, None),       # GQA 4, several tiles
    (1, 200, 4, 2, 16, False, None),     # ragged, non-causal
    (1, 200, 4, 1, 8, True, 50),         # ragged, window
    (1, 130, 4, 4, 40, True, None),      # MHA, D not a power of two
    (2, 128, 16, 4, 128, True, None),    # the flagship head width
    # bf16 here takes the tensor cores
    (1, 1000, 8, 1, 64, True, None),     # ragged, GQA 8, D 64
    (1, 1000, 4, 2, 128, True, 256),     # ragged, window, GQA 2
    (2, 300, 4, 4, 128, False, None),    # non-causal, MHA
    (1, 512, 16, 4, 64, True, 100),      # window, GQA 4, D 64
    (1, 10, 4, 2, 128, True, None),      # shorter than one tile
    (2, 70, 2, 2, 64, False, None),      # one tile and a ragged edge
])
def test_flash_bwd_matches_plain_version(card, dtype, b, s, h, h_kv, d,
                                         causal, window):
    td = getattr(torch, dtype)
    args = _bwd_inputs(card, td, b, s, h, h_kv, d, causal, window, s + d)
    tc = fa.tensor_core_route(*args[:4])
    assert tc == (td == torch.bfloat16 and d in (64, 128))
    names = [("flash_bwd_dq", tc), ("flash_bwd_dkv", tc)]
    n0 = _counts(names)
    dq = fa.flash_bwd_dq(*args, causal, window)
    dk, dv = fa.flash_bwd_dkv(*args, causal, window)
    torch.cuda.synchronize()
    assert _counts(names) == [n + 1 for n in n0]
    assert dq.dtype == dk.dtype == dv.dtype == td
    _assert_route_close((dq, dk, dv), args, (causal, window),
                        (fa.flash_bwd_dq_reference,
                         fa.flash_bwd_dkv_reference), tc, (causal, window))


@pytest.mark.cuda
def test_flash_autograd_runs_the_kernels_end_to_end(card):
    """The autograd Function on the card: forward kernel, delta with an
    lse cotangent, both backward kernels, against autograd through the
    plain forward."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(card).requires_grad_()
               for shape in ((2, 150, 4, 32), (2, 150, 2, 32), (2, 150, 2, 32)))
    go = torch.from_numpy(rng.standard_normal((2, 150, 4, 32), np.float32))
    gl = torch.from_numpy(rng.standard_normal((2, 4, 150), np.float32))
    go, gl = go.to(card), gl.to(card)
    launches = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out, lse = fa.flash_attention_with_lse(q, k, v, True, None)
    got = torch.autograd.grad((out * go).sum() + (lse * gl).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in launches)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, True, None)
    want = torch.autograd.grad((ref_out * go).sum() + (ref_lse * gl).sum(),
                               (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_flash_autograd_at_batch_one_takes_the_tensor_cores(card):
    """At B 1 autograd may hand the backward a dO whose batch stride is
    1 (a size-1 dimension's stride is arbitrary; the tensor-parallel
    step's is): bf16 at D 128, both backward kernels still take the
    tensor-core route, and give the first row of the same call at B 2."""
    rng = np.random.default_rng(12)
    q, k, v, go = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(card, torch.bfloat16) for shape in
                   ((2, 256, 4, 128), (2, 256, 2, 128), (2, 256, 2, 128),
                    (2, 256, 4, 128)))
    one = go[0].reshape(-1).clone().as_strided((1, 256, 4, 128),
                                               (1, 512, 128, 1))
    counts = (fa.wgmma_launches, fa.dq_wgmma_launches, fa.dkv_wgmma_launches)
    grads = []
    for rows, g in ((slice(0, 1), one), (slice(0, 2), go)):
        leaves = [x[rows].clone().requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves, True)
        grads.append([x[:1] for x in torch.autograd.grad(out, leaves, g)])
    torch.cuda.synchronize()
    assert (fa.wgmma_launches, fa.dq_wgmma_launches,
            fa.dkv_wgmma_launches) == tuple(n + 2 for n in counts)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_raises_on_a_head_dim_the_kernel_does_not_take(card):
    """A head dim of 0 is refused by the wrapper; past it, the C entry
    point refuses a launch whose sizes it does not take (head dim 0, or
    query heads that the KV heads do not divide). Every head dim from 1
    up is taken (test_head_dim_above_256_*)."""
    empty = torch.zeros(1, 64, 2, 0, device=card)
    rows = torch.zeros(1, 2, 64, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_bwd_dq(empty, empty, empty, empty, rows, rows)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_bwd_dkv(empty, empty, empty, empty, rows, rows)
    # Past the Python check, the C entry point refuses the launch and the
    # wrapper's error path raises with CUDA's message.
    args = _bwd_inputs(card, torch.float32, 1, 64, 2, 2, 264, True, None, 0)
    q, k, v, do = args[:4]
    dq = torch.empty_like(q)
    strides = [x.stride(i) for x in (q, k, v, do) for i in range(3)]
    for d, h_kv in ((0, 2), (264, 3)):
        with pytest.raises(RuntimeError, match="flash_bwd_dq kernel launch "
                                               "failed"):
            fa._call("flash_bwd", "hvd_flash_bwd_dq",
                     *[x.data_ptr() for x in args], dq.data_ptr(), 0,
                     1, 64, 2, h_kv, d, *strides, fa._scale(264), 1, 0,
                     fa._stream(q))


# Head dim 256: the CUDA-core loop at DMAX 256 (the forward's 64-row
# tiles in 197 KB of shared memory, the backward's 32-row tiles), for
# both input types (bf16 at D 256 is not the tensor cores' either).
D256_CASES = [  # (b, s, h, h_kv, causal, window)
    (1, 300, 4, 2, True, None),    # ragged, GQA 2
    (2, 128, 2, 2, False, None),   # non-causal, MHA
    (1, 200, 4, 1, True, 50),      # ragged, window, GQA 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,h_kv,causal,window", D256_CASES)
def test_head_dim_256_forward_and_backward_match_plain_versions(
        card, dtype, b, s, h, h_kv, causal, window):
    td = getattr(torch, dtype)
    q, k, v = _fwd_inputs(card, td, b, s, h, h_kv, 256, s + 7)
    assert not fa.tensor_core_route(q, k, v)
    n0 = _counts([("flash_fwd", False)])
    out, lse = fa.flash_attention_with_lse(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert _counts([("flash_fwd", False)]) == [n0[0] + 1]
    _assert_fwd_route_close(out, lse, (q, k, v), (causal, window),
                            fa.flash_attention_reference, False,
                            (causal, window))
    args = _bwd_inputs(card, td, b, s, h, h_kv, 256, causal, window, s + 8)
    names = [("flash_bwd_dq", False), ("flash_bwd_dkv", False)]
    n0 = _counts(names)
    dq = fa.flash_bwd_dq(*args, causal, window)
    dk, dv = fa.flash_bwd_dkv(*args, causal, window)
    torch.cuda.synchronize()
    assert _counts(names) == [n + 1 for n in n0]
    _assert_route_close((dq, dk, dv), args, (causal, window),
                        (fa.flash_bwd_dq_reference,
                         fa.flash_bwd_dkv_reference), False, (causal, window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_256_band_kernels_match_plain_versions(card, dtype):
    """The band entry points share the loop's D 256 tiles: a ragged tile
    at offset S with rows past the window that see no key."""
    b, s, h, h_kv, off, window = 1, 200, 4, 2, 200, 150
    td = getattr(torch, dtype)
    args = _band_inputs(card, td, b, s, h, h_kv, 256, off, window, 5)
    q, k, v = args[:3]
    out, lse = fa.flash_band_fwd(q, k, v, off, window)
    dq = fa.flash_band_dq(*args, off, window)
    dk, dv = fa.flash_band_dkv(*args, off, window)
    torch.cuda.synchronize()
    live = _live_rows(s, off, window).to(card)
    assert (lse[:, :, ~live] <= -1e29).all()
    _assert_fwd_route_close(out, lse, (q, k, v), (off, window),
                            fa.flash_band_fwd_reference, False,
                            (True, window, off), rows=live)
    _assert_route_close((dq, dk, dv), args, (off, window),
                        (fa.flash_band_dq_reference,
                         fa.flash_band_dkv_reference), False,
                        (True, window, off))


# Head dims above 256: the loop in 256-column pieces (the score sums run
# over the pieces; grid.z gives each CTA one piece of the output).
WIDE_CASES = [  # (b, s, h, h_kv, d, causal, window)
    (1, 300, 4, 2, 320, True, None),   # ragged, GQA 2, a partial piece
    (2, 128, 2, 2, 512, False, None),  # non-causal, MHA, two full pieces
    (1, 200, 4, 1, 320, True, 50),     # ragged, window, GQA 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,h_kv,d,causal,window", WIDE_CASES)
def test_head_dim_above_256_forward_and_backward_match_plain_versions(
        card, dtype, b, s, h, h_kv, d, causal, window):
    td = getattr(torch, dtype)
    q, k, v = _fwd_inputs(card, td, b, s, h, h_kv, d, s + 17)
    assert not fa.tensor_core_route(q, k, v)
    n0 = _counts([("flash_fwd", False)])
    out, lse = fa.flash_attention_with_lse(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert _counts([("flash_fwd", False)]) == [n0[0] + 1]
    _assert_fwd_route_close(out, lse, (q, k, v), (causal, window),
                            fa.flash_attention_reference, False,
                            (causal, window))
    args = _bwd_inputs(card, td, b, s, h, h_kv, d, causal, window, s + 18)
    names = [("flash_bwd_dq", False), ("flash_bwd_dkv", False)]
    n0 = _counts(names)
    dq = fa.flash_bwd_dq(*args, causal, window)
    dk, dv = fa.flash_bwd_dkv(*args, causal, window)
    torch.cuda.synchronize()
    assert _counts(names) == [n + 1 for n in n0]
    _assert_route_close((dq, dk, dv), args, (causal, window),
                        (fa.flash_bwd_dq_reference,
                         fa.flash_bwd_dkv_reference), False, (causal, window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [320, 512])
def test_head_dim_above_256_band_kernels_match_plain_versions(card, dtype,
                                                               d):
    """The band entry points in pieces: a ragged tile at offset S with
    rows past the window that see no key."""
    b, s, h, h_kv, off, window = 1, 200, 4, 2, 200, 150
    td = getattr(torch, dtype)
    args = _band_inputs(card, td, b, s, h, h_kv, d, off, window, 25)
    q, k, v = args[:3]
    out, lse = fa.flash_band_fwd(q, k, v, off, window)
    dq = fa.flash_band_dq(*args, off, window)
    dk, dv = fa.flash_band_dkv(*args, off, window)
    torch.cuda.synchronize()
    live = _live_rows(s, off, window).to(card)
    assert (lse[:, :, ~live] <= -1e29).all()
    _assert_fwd_route_close(out, lse, (q, k, v), (off, window),
                            fa.flash_band_fwd_reference, False,
                            (True, window, off), rows=live)
    _assert_route_close((dq, dk, dv), args, (off, window),
                        (fa.flash_band_dq_reference,
                         fa.flash_band_dkv_reference), False,
                        (True, window, off))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_takes_batch_times_heads_past_65535(card, dtype):
    """B 4100 x H 16 = 65,600 (B*H rides grid.x, whose limit is 2^31 - 1;
    grid.y stops at 65535): f32 on the loop, bf16 on the tensor cores."""
    b, s, h, h_kv, d = 4100, 32, 16, 1, 64
    td = getattr(torch, dtype)
    q, k, v = _fwd_inputs(card, td, b, s, h, h_kv, d, 3)
    tc = fa.tensor_core_route(q, k, v)
    assert tc == (td == torch.bfloat16)
    out, lse = fa.flash_attention_with_lse(q, k, v, True, None)
    torch.cuda.synchronize()
    _assert_fwd_route_close(out, lse, (q, k, v), (True, None),
                            fa.flash_attention_reference, tc, (True, None))


def _live_rows(s, off, window):
    """Rows of a band tile at offset ``off`` with at least one live key."""
    lo, hi = fa.band_key_span(s, off, window)
    return lo <= hi


def _band_inputs(card, dtype, b, s, h, h_kv, d, off, window, seed):
    """q, k, v, dO in ``dtype``; a finite global lse (the band tile's
    merged with a diagonal tile's, as the ring merges them) and a delta."""
    rng = np.random.default_rng(seed)
    q, k, v, do, k2, v2 = (
        torch.from_numpy(rng.standard_normal(shape, np.float32)).to(card, dtype)
        for shape in ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d),
                      (b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d)))
    _, lse_band = fa.flash_band_fwd_reference(q, k, v, off, window)
    _, lse_diag = fa.flash_attention_reference(q, k2, v2, True, window)
    lse = torch.logaddexp(lse_band, lse_diag)
    delta = torch.from_numpy(rng.standard_normal((b, h, s), np.float32))
    delta = delta.to(card)
    return q, k, v, do, lse, delta


BAND_CASES = [  # (b, s, h, h_kv, d, off, window)
    (1, 130, 4, 2, 8, 130, 100),       # ragged, dead rows past the window
    (1, 200, 4, 1, 16, 400, 300),      # off 2S, GQA 4, dead rows
    (1, 128, 4, 4, 40, 128, None),     # fully visible, MHA, odd D
    (2, 256, 16, 4, 128, 256, 384),    # the flagship head width, half band
    # bf16 here takes the tensor cores
    (1, 1000, 8, 1, 128, 1000, 700),   # off S, ragged, GQA 8, dead rows
    (1, 512, 4, 2, 64, 1024, 800),     # off 2S, GQA 2, dead rows
    (1, 300, 4, 4, 128, 300, None),    # fully visible, ragged, MHA
    (1, 50, 4, 1, 128, 50, 30),        # shorter than one tile, dead rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,h_kv,d,off,window", BAND_CASES)
def test_flash_band_fwd_matches_plain_version(card, dtype, b, s, h, h_kv, d,
                                              off, window):
    """Live rows match the plain version; a row with no live key ends
    with a finite out and lse <= -1e29 on both sides."""
    td = getattr(torch, dtype)
    q, k, v = _band_inputs(card, td, b, s, h, h_kv, d, off, window, s)[:3]
    tc = fa.tensor_core_route(q, k, v)
    assert tc == (td == torch.bfloat16 and d in (64, 128))
    names = [("flash_band_fwd", False), ("flash_band_fwd", True)]
    n0 = _counts(names)
    out, lse = fa.flash_band_fwd(q, k, v, off, window)
    torch.cuda.synchronize()
    assert _counts(names) == [n0[0] + (not tc), n0[1] + tc]
    assert out.dtype == td and lse.dtype == torch.float32
    live = _live_rows(s, off, window).to(card)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _assert_fwd_route_close(out, lse, (q, k, v), (off, window),
                            fa.flash_band_fwd_reference, tc,
                            (True, window, off), rows=live)
    _, ref_lse = fa.flash_band_fwd_reference(q, k, v, off, window)
    assert (lse[:, :, ~live] <= -1e29).all()
    assert (ref_lse[:, :, ~live] <= -1e29).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,h_kv,d,off,window", BAND_CASES)
def test_flash_band_bwd_matches_plain_version(card, dtype, b, s, h, h_kv, d,
                                              off, window):
    """f32 gradients, dk/dv summed over each GQA group in the kernel."""
    td = getattr(torch, dtype)
    args = _band_inputs(card, td, b, s, h, h_kv, d, off, window, s + 1)
    tc = fa.tensor_core_route(*args[:4])
    assert tc == (td == torch.bfloat16 and d in (64, 128))
    names = [("flash_band_dq", tc), ("flash_band_dkv", tc)]
    n0 = _counts(names)
    dq = fa.flash_band_dq(*args, off, window)
    dk, dv = fa.flash_band_dkv(*args, off, window)
    torch.cuda.synchronize()
    assert _counts(names) == [n + 1 for n in n0]
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    _assert_route_close((dq, dk, dv), args, (off, window),
                        (fa.flash_band_dq_reference,
                         fa.flash_band_dkv_reference), tc, (True, window, off))


@pytest.mark.cuda
def test_ring_attention_on_the_card_runs_the_band_kernels(card):
    """A local ring of 4 on the card with a window: forward and gradients
    through the static and band kernels, against dense attention."""
    from horovod_tpu_torch.parallel.ring_attention import (RingAxis,
                                                            dense_attention,
                                                            ring_attention)
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(card).requires_grad_()
               for shape in ((1, 256, 4, 16), (1, 256, 2, 16), (1, 256, 2, 16)))
    g = torch.from_numpy(rng.standard_normal((1, 256, 4, 16), np.float32))
    g = g.to(card)
    counts = (fa.band_launches, fa.band_dq_launches, fa.band_dkv_launches)
    out = ring_attention(q, k, v, RingAxis.local(4), impl="flash", window=100)
    got = torch.autograd.grad((out * g).sum(), (q, k, v))
    torch.cuda.synchronize()
    # steps = 2 + 98 // 64 = 3: shards 1-3 at step 1, 2-3 at step 2
    assert (fa.band_launches, fa.band_dq_launches, fa.band_dkv_launches) == \
        tuple(n + 5 for n in counts)
    ref = dense_attention(q, k, v, window=100)
    want = torch.autograd.grad((ref * g).sum(), (q, k, v))
    torch.testing.assert_close(out, ref, atol=ATOL["float32"], rtol=0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=GRAD_ATOL, rtol=0)


def _ring_view(x, shard, n, seed):
    """``x`` (B, H, S) as the strided shard ``shard`` of a (B, H, n * S)
    tensor of random rows, as a chunk of the ring's lse is."""
    b, h, s = x.shape
    wide = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, h, n * s), np.float32)).to(x.device)
    wide[..., shard * s:(shard + 1) * s] = x
    view = wide.chunk(n, dim=2)[shard]
    assert not view.is_contiguous()
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv",
                                    "flash_band_dq", "flash_band_dkv"])
@pytest.mark.parametrize("b,s,h,h_kv,d", [
    (2, 2048, 32, 32, 2),   # dq and dk/dv (bf16) the size of lse's copy
    (1, 512, 32, 8, 8),     # GQA 4, several waves of small CTAs
    (1, 512, 16, 4, 128),   # the tensor-core route
])
def test_backward_kernels_take_a_strided_lse(card, kernel, b, s, h, h_kv, d):
    """An lse and delta that are strided chunks of the ring's (B, H, n*S)
    give the same bits as dense copies. The wrapper copies them to dense
    and must hold the copy until the launch is enqueued: freed earlier,
    its block may go to the outputs, whose writes then overwrite lse rows
    that CTAs of a later wave have not yet read."""
    band = kernel.startswith("flash_band")
    off, window = (s, 3 * s // 2) if band else (None, None)
    args = _bwd_inputs(card, torch.bfloat16, b, s, h, h_kv, d, True, window,
                       s + d)
    q, k, v, do, lse, delta = args
    if band:
        _, lse_band = fa.flash_band_fwd_reference(q, k, v, off, window)
        lse = torch.logaddexp(lse, lse_band)
    strided = (_ring_view(lse, 1, 4, 1), _ring_view(delta, 1, 4, 2))
    extra = (off, window) if band else (True, None)
    fn = getattr(fa, kernel)
    got = fn(q, k, v, do, *strided, *extra)
    torch.cuda.synchronize()
    want = fn(q, k, v, do, lse, delta, *extra)
    tc = fa.tensor_core_route(q, k, v, do)
    assert tc == (d == 128)
    plain = getattr(fa, kernel + "_reference")(
        q, k, v, do, lse, delta, *extra,
        operand_dtype=torch.bfloat16 if tc else None)
    got, want, plain = (_tuple(x) for x in (got, want, plain))
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
        if band and not tc:
            torch.testing.assert_close(g, p, atol=GRAD_ATOL, rtol=0)
        else:
            _assert_grad_close(g, p, torch.bfloat16)


def _all_backward(args, band, off, window):
    """dq, dk, dv of the static kernels on ``args`` and of the band
    kernels on ``band`` at ``off``."""
    return (fa.flash_bwd_dq(*args, True, window),
            *fa.flash_bwd_dkv(*args, True, window),
            fa.flash_band_dq(*band, off, window),
            *fa.flash_band_dkv(*band, off, window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_are_deterministic(card, dtype):
    """Two runs of every backward kernel on the same inputs give the same
    bits, on either route: each CTA owns its output tile and sums in a
    fixed order (the dkv warpgroups' partials too), with no atomics."""
    td = getattr(torch, dtype)
    args = _bwd_inputs(card, td, 2, 700, 8, 2, 128, True, 300, 3)
    band = _band_inputs(card, td, 1, 512, 8, 2, 128, 512, 700, 4)
    first = _all_backward(args, band, 512, 700)
    second = _all_backward(args, band, 512, 700)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_kernels_are_deterministic(card, dtype):
    """Two runs of each forward kernel on the same inputs give the same
    bits, on either route: each CTA owns its rows, with no atomics."""
    td = getattr(torch, dtype)
    q, k, v = _fwd_inputs(card, td, 2, 700, 8, 2, 128, 5)
    runs = [(*fa.flash_attention_with_lse(q, k, v, True, 300),
             *fa.flash_band_fwd(q, k, v, 700, 900)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tc", [("bfloat16", True),
                                      ("float32", False)])
def test_forward_route_follows_the_rule(card, dtype, tc):
    """A bf16 call at D 128 launches the tensor-core forward kernels and
    an f32 one the CUDA-core loop, each counted on its own route only; a
    bf16 call at D 96 takes the loop."""
    td = getattr(torch, dtype)
    q, k, v = _fwd_inputs(card, td, 1, 256, 4, 2, 128, 13)
    assert fa.tensor_core_route(q, k, v) is tc
    names = [(n, route) for n in ("flash_fwd", "flash_band_fwd")
             for route in (False, True)]
    n0 = _counts(names)
    fa.flash_attention_with_lse(q, k, v, True, None)
    fa.flash_band_fwd(q, k, v, 256, 384)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(n0, _counts(names))] == \
        [int(route == tc) for _, route in names]
    q, k, v = _fwd_inputs(card, torch.bfloat16, 1, 64, 2, 2, 96, 14)
    assert not fa.tensor_core_route(q, k, v)
    n0 = _counts(names)
    fa.flash_attention_with_lse(q, k, v, True, None)
    assert [b - a for a, b in zip(n0, _counts(names))] == [1, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tc", [("bfloat16", True),
                                      ("float32", False)])
def test_backward_route_follows_the_rule(card, dtype, tc):
    """A bf16 call at D 128 launches the tensor-core kernels and an f32
    one the CUDA-core loop, each counted on its own route only."""
    td = getattr(torch, dtype)
    args = _bwd_inputs(card, td, 1, 256, 4, 2, 128, True, None, 9)
    band = _band_inputs(card, td, 1, 256, 4, 2, 128, 256, 384, 10)
    assert fa.tensor_core_route(*args[:4]) is tc
    names = [(n, route) for n in ROUTE_COUNTERS if "fwd" not in n
             for route in (False, True)]
    n0 = _counts(names)
    _all_backward(args, band, 256, 384)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(n0, _counts(names))] == \
        [int(route == tc) for _, route in names]
