"""Fused attention on Hopper, forward and backward, ring attention's
band tiles, and paged decode attention.

Counterpart of horovod_tpu/ops/flash_attention.py. The TPU kernels
``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (Pallas)
become CUDA C++ kernels for sm_90a, ``ops/csrc/flash_fwd.cu`` and
``ops/csrc/flash_bwd.cu``, built at first use (ops/_build.py) and called
through a plain C interface. Same contract as the JAX package: q
(B, S, H, D), k/v (B, S, H_kv, D) with H % H_kv == 0, causal by default,
optional sliding ``window`` (requires causal).

The band kernels ``_band_fwd_kernel``, ``_band_dq_kernel`` and
``_band_dkv_kernel`` compute ring attention's tile of a visiting K/V
shard, whose query rows sit ``off`` global positions after the K/V
origin (causal, and windowed, at that offset): :func:`flash_band_fwd`,
:func:`flash_band_dq` and :func:`flash_band_dkv`. They run the same
CUDA kernels as the static ones, which are the band kernels at offset
0, and take ``off`` as an int argument where the TPU kernels took an
SMEM scalar. Their gradients come out in f32, and dK/dV are summed
over each GQA group inside the kernel. :func:`_tile_lse` and
:func:`_tile_bwd_dispatch` are the per-tile entry points that
parallel/ring_attention.py calls.

:func:`flash_attention` and :func:`flash_attention_with_lse` are
``torch.autograd.Function``s, as the JAX functions are custom VJPs. The
forward saves q, k, v, out and lse; the backward computes
``delta = rowsum(dO * O)`` in f32 in plain torch (the JAX package runs it
outside Pallas too), subtracts the lse cotangent from it, and calls
:func:`flash_bwd_dq` and :func:`flash_bwd_dkv`.

Every kernel wrapper, forward and backward, static and band, takes one
of two routes by the rule :func:`tensor_core_route`: bf16 operands with
D 64 or 128 and 16-byte-aligned pointers and strides go to the
tensor-core kernels (``*_wgmma``: TMA, wgmma, warp specialisation),
everything else, f32 among it, to the CUDA-core loop with exact f32
products and the reference's order of operations. Every route takes any
B*H (it is the grid's x dimension); the loop takes any head dim, one
above 256 in 256-column pieces (its CTAs recompute the scores once per
piece of the output). Each route counts its
own launches (``launches`` and ``wgmma_launches`` for ``flash_fwd``,
and so on), on the host where it launches. A CUDA graph's replay runs
no host code, so a captured program takes its capture's counts back
(:func:`uncount_capture`) and adds them on every replay
(:func:`count_replay`). The tensor-core route computes the scores as
``(q.k^T) * scale`` from the unscaled bf16 q and rounds P to bf16
before ``P.V`` (P and dS before the backward's second products), as
SDPA does; the forward's ``l`` sums the f32 p. Inside
:func:`count_flops` every launch also adds its FLOPs (4, 6 and 8 x D a
live (query, key) pair for the forward, dq and dkv kernels): a ctypes
launch is invisible to ``torch.utils.flop_counter.FlopCounterMode``,
which counts the rest of a compiled step's work. Both routes keep the
masked scores at ``NEG_INF`` (-1e30) in natural-log units, so a row with
no live key ends with lse <= -1e29, as the ring's merge needs.

On a CUDA tensor every wrapper launches its kernel or raises; on a CPU
tensor it computes the kernel's plain version
(:func:`flash_attention_reference`, :func:`flash_bwd_dq_reference`,
:func:`flash_bwd_dkv_reference` and the ``flash_band_*_reference``
functions, in the reference's f32 arithmetic; each takes
``operand_dtype=torch.bfloat16`` for the tensor-core route's, and
:func:`fwd_bf16_rounding_bound` and :func:`bf16_rounding_bound` say how
far that may lie from the f32 one). Ragged lengths need no special
path on the card: the kernels mask the edge themselves, where the TPU
kernels padded causal lengths to a multiple of 128 and ran non-causal
ones dense.

:func:`paged_attention_decode` is plain torch, as the JAX package runs
it as plain XLA with no Pallas kernel.
"""

import contextlib
import ctypes

import torch

from ..parallel.ring_attention import NEG_INF, f32_scale, gqa_group
from . import _build

# Launches of each CUDA kernel (one per wrapper call on the card). The
# plain versions on the CPU do not count. Every wrapper counts the
# CUDA-core loop and the tensor-core route apart.
launches = 0                 # flash_fwd, loop
dq_launches = 0              # flash_bwd_dq, loop
dkv_launches = 0             # flash_bwd_dkv, loop
band_launches = 0            # flash_band_fwd, loop
band_dq_launches = 0         # flash_band_dq, loop
band_dkv_launches = 0        # flash_band_dkv, loop
wgmma_launches = 0           # flash_fwd, tensor cores
band_wgmma_launches = 0      # flash_band_fwd, tensor cores
dq_wgmma_launches = 0        # flash_bwd_dq, tensor cores
dkv_wgmma_launches = 0       # flash_bwd_dkv, tensor cores
band_dq_wgmma_launches = 0   # flash_band_dq, tensor cores
band_dkv_wgmma_launches = 0  # flash_band_dkv, tensor cores

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# scale, then causal (static kernels) or off (band kernels), window, stream
_TAIL = [ctypes.c_float, _I, _I, _P]
_FWD = [_P] * 5 + [_I] * 6 + [_L] * 9 + _TAIL
_DQ = [_P] * 7 + [_I] * 6 + [_L] * 12 + _TAIL
_DKV = [_P] * 8 + [_I] * 6 + [_L] * 12 + _TAIL
# Each kernel: its source, the C signature of its entry points (pointers,
# dtype and sizes, strides, tail) and the prefix of its counters.
_KERNELS = {
    "flash_fwd": ("flash_fwd", _FWD, ""),
    "flash_band_fwd": ("flash_fwd", _FWD, "band_"),
    "flash_bwd_dq": ("flash_bwd", _DQ, "dq_"),
    "flash_bwd_dkv": ("flash_bwd", _DKV, "dkv_"),
    "flash_band_dq": ("flash_bwd", _DQ, "band_dq_"),
    "flash_band_dkv": ("flash_bwd", _DKV, "band_dkv_"),
}
# C entry points per source: each kernel on both routes, and the
# tensor-core kernels' shared-memory report.
_SIGNATURES = {
    source: {f"hvd_{name}{route}": sig
             for name, (src, sig, _) in _KERNELS.items() if src == source
             for route in ("", "_wgmma")}
    for source in ("flash_fwd", "flash_bwd")}
_SIGNATURES["flash_fwd"]["hvd_flash_fwd_wgmma_smem"] = [_I]
_SIGNATURES["flash_bwd"]["hvd_flash_bwd_wgmma_smem"] = [_I, _I]
# The counter of each kernel, by route (tensor cores or not).
_COUNTERS = {name: {False: f"{prefix}launches",
                    True: f"{prefix}wgmma_launches"}
             for name, (_, _, prefix) in _KERNELS.items()}
_COUNTER_NAMES = tuple(c for routes in _COUNTERS.values()
                       for c in routes.values())
_libs = {}


def launch_counts():
    """{counter name: launches so far} of every kernel and route."""
    return {c: globals()[c] for c in _COUNTER_NAMES}


def uncount_capture(before):
    """Launches counted since ``before`` (:func:`launch_counts`) that a
    CUDA graph capture recorded rather than ran: take them back off the
    counters and return them, for :func:`count_replay` to add on every
    replay of the graph."""
    captured = {c: globals()[c] - n for c, n in before.items()
                if globals()[c] != n}
    for c, n in captured.items():
        globals()[c] -= n
    return captured


_flops = None  # [FLOPs so far] inside count_flops(), else None


@contextlib.contextmanager
def count_flops():
    """Count the FLOPs of every kernel launched in the block, on any
    thread (autograd's device thread runs the backward): yields a
    one-element list holding the running total."""
    global _flops
    prev, _flops = _flops, [0]
    try:
        yield _flops
    finally:
        _flops = prev


def _live_pairs(s, causal, window, off=None):
    """(query, key) pairs a tile's mask keeps in one (b, h) row."""
    if off is None and not causal:
        return s * s
    lo, hi = band_key_span(s, 0 if off is None else off, window)
    return int((hi - lo + 1).clamp(min=0).sum())


def _launch_flops(name, sizes, tail):
    """FLOPs of one launch of ``name``: per live pair 4 x D (forward),
    6 x D (dq: s, dp, dS.K) or 8 x D (dkv: s, dp, P^T.dO, dS^T.Q)."""
    b, s, h, _, d = sizes
    _, mode, win = tail
    band = name.startswith("flash_band")
    pairs = _live_pairs(s, bool(mode) or band, win or None,
                        int(mode) if band else None)
    per_pair = 8 if name.endswith("dkv") else 6 if name.endswith("dq") \
        else 4
    return per_pair * d * pairs * b * h


def count_replay(captured):
    """Count one replay of a graph whose capture recorded ``captured``
    launches (:func:`uncount_capture`)."""
    for c, n in captured.items():
        globals()[c] += n


def _kernel_lib(name):
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _call(source, fn, *args):
    """Call C entry point ``fn`` of ``source``; raise on a failed
    launch (the function returns ``cudaGetLastError()``)."""
    lib = _kernel_lib(source)
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(
            f"{fn[len('hvd_'):]} kernel launch failed: "
            f"{lib.hvd_cuda_error_string(err).decode()}")


def _scale(d):
    """The kernel's ``1.0 / (d ** 0.5)``: a Python float that JAX casts
    to f32 when it multiplies the f32 q tile."""
    return float(torch.tensor(1.0 / (d ** 0.5), dtype=torch.float32))


def _check(q, k, v, causal, window):
    """The argument checks of ``_flash_fwd_impl`` plus what the kernel
    takes; returns the GQA group."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, S, H, D) tensors")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    group = gqa_group(q.shape[2], k.shape[2], v.shape[2])
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention takes float32 or bfloat16 q/k/v of one dtype,"
            f" got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    return group


def _check_bwd(q, k, v, do, lse, delta, causal, window):
    """:func:`_check` plus the backward's own operands: dO shaped and
    typed as q, lse and delta (B, H, S) f32 on q's device."""
    _check(q, k, v, causal, window)
    b, s, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"dO must match q: got {tuple(do.shape)} {do.dtype} on "
            f"{do.device}, q {tuple(q.shape)} {q.dtype} on {q.device}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, s) or x.dtype != torch.float32 \
                or x.device != q.device:
            raise ValueError(
                f"{name} must be (B, H, S) = {(b, h, s)} float32 on "
                f"{q.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")


def _expand_kv(q, k, v, prescale=True):
    """f32 (q * scale, or q with ``prescale`` False, k, v) with k/v
    repeated over each GQA group."""
    group = q.shape[2] // k.shape[2]
    qf = q.float() * _scale(q.shape[3]) if prescale else q.float()
    return (qf, k.float().repeat_interleave(group, dim=2),
            v.float().repeat_interleave(group, dim=2))


def _scores(qf, kf, causal, window, off=0, scale=None):
    """(B, H, S, S) f32 scores ``qf.k^T`` (times ``scale`` if given) with
    masked entries at ``NEG_INF``; query row i sits at position
    ``off + i``."""
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if scale is not None:
        sc = sc * scale
    if causal:
        pos = torch.arange(qf.shape[1], device=qf.device)
        dist = off + pos[:, None] - pos[None, :]
        keep = dist >= 0
        if window is not None:
            keep = keep & (dist < window)
        sc = torch.where(keep, sc, NEG_INF)
    return sc


def _fwd_probs(q, k, v, causal, window, off=0, operand_dtype=None):
    """f32 ``(p, l, v expanded)`` of the whole rows, ``p`` against the
    row max and ``l`` its clamped sum; ``m`` and ``l`` give the lse. With
    ``operand_dtype`` None the scores are ``(q*scale).k^T``, the
    reference's; otherwise ``(q.k^T)*scale``, the tensor-core route's."""
    _check(q, k, v, causal, window)
    exact = operand_dtype is None
    qf, kf, vf = _expand_kv(q, k, v, prescale=exact)
    sc = _scores(qf, kf, causal, window, off,
                 None if exact else _scale(q.shape[3]))
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    return p, m, torch.clamp(p.sum(dim=-1), min=1e-30), vf


def _fwd_math(q, k, v, causal, window, off=0, operand_dtype=None):
    """(out in q's dtype, lse f32) of the whole rows at query offset
    ``off``: the loop's f32 arithmetic, or with ``operand_dtype`` the
    tensor-core route's, p rounded to it before ``p.v`` and l summed from
    the f32 p."""
    p, m, l, vf = _fwd_probs(q, k, v, causal, window, off, operand_dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", _operand(p, operand_dtype), vf) \
        / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l)


def flash_attention_reference(q, k, v, causal=True, window=None,
                              operand_dtype=None):
    """Plain version of the kernel: ``(out (B, S, H, D) in q's dtype,
    lse (B, H, S) f32)``, with ``_fwd_kernel``'s f32 arithmetic — q
    converted to f32 and scaled by ``1/sqrt(D)`` before the product,
    masked scores filled with ``NEG_INF``, ``l`` clamped at 1e-30 — taken
    over the whole row at once instead of tile by tile.
    ``operand_dtype=torch.bfloat16`` gives the tensor-core route's
    arithmetic instead: scores ``(q.k^T)*scale``, p rounded to bf16
    before ``p.v``, l summed from the f32 p."""
    return _fwd_math(q, k, v, causal, window, 0, operand_dtype)


def flash_band_fwd_reference(q, k, v, off, window=None, operand_dtype=None):
    """Plain version of ``flash_band_fwd``: ``_band_fwd_kernel``'s f32
    arithmetic (as :func:`flash_attention_reference`, p kept in f32)
    for a causal tile whose query row i sits at position ``off + i``.
    A row with no live key gets lse ``NEG_INF`` (to f32 precision) and a
    finite out, the mean of V, which the ring's lse merge weights by 0.
    ``operand_dtype`` as for :func:`flash_attention_reference`."""
    return _fwd_math(q, k, v, True, window, off, operand_dtype)


def fwd_bf16_rounding_bound(q, k, v, causal=True, window=None, off=0):
    """How far the tensor-core route's forward out may lie from the f32
    plain version because p is rounded to bf16 before ``p.v``: each
    rounding moves a term by at most 2^-8 of itself and l is summed from
    the f32 p, so an out element moves by at most 2^-8 of
    ``(sum_j p_j |v_j|) / l`` over its row. Returns the largest such
    value. The rounding of the bf16 output and f32 summation order come
    on top; lse does not move."""
    p, _, l, vf = _fwd_probs(q, k, v, causal, window, off, torch.bfloat16)
    mag = torch.einsum("bhqk,bkhd->bqhd", p, vf.abs()) \
        / l.transpose(1, 2)[..., None]
    return 2.0 ** -8 * mag.max().item()


def _bwd_common(q, k, v, do, lse, delta, causal, window, off=0,
                operand_dtype=None):
    """f32 ``(q side, k, p, dS)`` of the whole rows, k/v expanded. With
    ``operand_dtype`` None the loop's arithmetic: scores ``(q*scale).k^T``
    and the q side ``q*scale``. Otherwise the tensor-core route's: scores
    ``(q.k^T)*scale`` and the q side unscaled (dK takes the scale once at
    the end)."""
    _check_bwd(q, k, v, do, lse, delta, causal, window)
    exact = operand_dtype is None
    qf, kf, vf = _expand_kv(q, k, v, prescale=exact)
    scale = None if exact else _scale(q.shape[3])
    p = torch.exp(_scores(qf, kf, causal, window, off, scale)
                  - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    return qf, kf, p, p * (dp - delta[..., None])


def _operand(x, operand_dtype):
    """``x`` rounded to ``operand_dtype`` (and back to f32), or as it
    is for None: P and dS as the second products take them."""
    return x if operand_dtype is None else x.to(operand_dtype).float()


def _dq_math(q, k, v, do, lse, delta, causal, window, off=0,
             operand_dtype=None):
    """f32 ``scale * dS.K`` of the whole rows."""
    _, kf, _, ds = _bwd_common(q, k, v, do, lse, delta, causal, window, off,
                               operand_dtype)
    ds = _operand(ds, operand_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf) * _scale(q.shape[3])


def _dkv_math(q, k, v, do, lse, delta, causal, window, off=0,
              operand_dtype=None):
    """f32 ``(dS^T.(q*scale), P^T.dO)``, summed over each GQA group; with
    an ``operand_dtype``, ``dS^T.q`` summed and then scaled."""
    qf, _, p, ds = _bwd_common(q, k, v, do, lse, delta, causal, window, off,
                               operand_dtype)
    b, s, h_kv, d = k.shape
    dk = torch.einsum("bhqk,bqhd->bkhd", _operand(ds, operand_dtype), qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", _operand(p, operand_dtype),
                      do.float())
    dk = dk.reshape(b, s, h_kv, -1, d).sum(dim=3)
    if operand_dtype is not None:
        dk = dk * _scale(d)
    return dk, dv.reshape(b, s, h_kv, -1, d).sum(dim=3)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=True,
                           window=None, operand_dtype=None):
    """Plain version of ``flash_bwd_dq``: dQ (B, S, H, D) in q's dtype,
    ``scale * dS.K`` with ``_bwd_dq_kernel``'s f32 arithmetic —
    ``p = exp(s - lse)``, ``dS = p * (dO.V^T - delta)`` — over the whole
    row at once. ``operand_dtype=torch.bfloat16`` gives the tensor-core
    route's arithmetic instead: ``s = (q.k^T)*scale``, dS rounded to bf16
    before ``dS.K``."""
    return _dq_math(q, k, v, do, lse, delta, causal, window, 0,
                    operand_dtype).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=True,
                            window=None, operand_dtype=None):
    """Plain version of ``flash_bwd_dkv``: (dK, dV), each (B, S, H_kv, D)
    in k's dtype — ``dV = P^T.dO`` and ``dK = dS^T.(q*scale)`` per query
    head, as ``_bwd_dkv_kernel`` computes them, summed in f32 over each
    GQA group before the cast. ``operand_dtype=torch.bfloat16`` gives the
    tensor-core route's arithmetic: P and dS rounded to bf16 before the
    products, ``dK = scale * dS^T.q``."""
    dk, dv = _dkv_math(q, k, v, do, lse, delta, causal, window, 0,
                       operand_dtype)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_band_dq_reference(q, k, v, do, lse, delta, off, window=None,
                            operand_dtype=None):
    """Plain version of ``flash_band_dq``: ``_band_dq_kernel``'s
    arithmetic for the band tile at offset ``off``, from the ring's
    global ``lse`` and ``delta``; dQ (B, S, H, D) in f32.
    ``operand_dtype`` as for :func:`flash_bwd_dq_reference`."""
    return _dq_math(q, k, v, do, lse, delta, True, window, off,
                    operand_dtype)


def flash_band_dkv_reference(q, k, v, do, lse, delta, off, window=None,
                             operand_dtype=None):
    """Plain version of ``flash_band_dkv``: (dK, dV), each
    (B, S, H_kv, D) in f32, ``_band_dkv_kernel``'s per-head arithmetic
    summed over each GQA group. ``operand_dtype`` as for
    :func:`flash_bwd_dkv_reference`."""
    return _dkv_math(q, k, v, do, lse, delta, True, window, off,
                     operand_dtype)


def bf16_rounding_bound(q, k, v, do, lse, delta, causal=True, window=None,
                        off=0):
    """(dq, dk, dv): how far the tensor-core route's gradients may lie
    from the f32 plain versions because P and dS are rounded to bf16
    before the second products. Each rounding moves a term by at most
    2^-8 of itself, so an output element moves by at most 2^-8 of the
    same sum over absolute values: the largest element of
    ``2^-8 * scale * |dS|.|K|``, ``2^-8 * scale * |dS^T|.|Q|`` and
    ``2^-8 * |P^T|.|dO|`` (summed over each GQA group). The rounding of a
    bf16 output and f32 summation order come on top."""
    qf, kf, p, ds = _bwd_common(q, k, v, do, lse, delta, causal, window, off,
                                torch.bfloat16)
    b, s, h_kv, d = k.shape
    unit, scale = 2.0 ** -8, _scale(d)
    ds, p = ds.abs(), p.abs()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf.abs())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf.abs())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs())
    dk, dv = (x.reshape(b, s, h_kv, -1, d).sum(dim=3) for x in (dk, dv))
    return (unit * scale * dq.max().item(), unit * scale * dk.max().item(),
            unit * dv.max().item())


def band_key_span(s, off=0, window=None):
    """(lo, hi), int64 (s,): the first and last of ``s`` keys that query
    row i of a causal tile at offset ``off`` sees (row i sits at position
    off + i; key j is live if 0 <= off + i - j < window). A row with
    lo > hi sees no key. The per-row form of the JAX package's
    ``_band_live``, for the tests' and the smoke run's masks and counts."""
    r = torch.arange(s, dtype=torch.int64)
    hi = torch.clamp(off + r, max=s - 1)
    if window is None:
        return torch.zeros_like(r), hi
    return torch.clamp(off + r - window + 1, min=0), hi


def dq_key_tiles(r0, n, s, off=0, causal=True, window=None, tile=64):
    """[lo, hi) of the ``tile``-row key tiles that query rows
    [r0, r0 + n) of an ``s``-row tile at offset ``off`` can see (rows at
    or past ``s`` do not exist); lo == hi when they see none. The Python
    mirror of ``key_tiles`` in ops/csrc/flash_bwd.cu: the tensor-core dq
    kernel's loop bounds for each 64-row warpgroup."""
    end = min(r0 + n, s)
    first, stop = 0, s
    if causal:
        stop = min(s, off + end)
        if window is not None:
            first = max(0, off + r0 - window + 1)
    if end <= r0 or stop <= first:
        return 0, 0
    return first // tile, -(-stop // tile)


def dkv_query_tiles(k0, s, off=0, causal=True, window=None, tile=64):
    """[lo, hi) of the ``tile``-row query tiles with a row that can see a
    key of the key tile [k0, k0 + tile) of an ``s``-row tile at offset
    ``off``; lo == hi when none can. The Python mirror of ``query_tiles``
    in ops/csrc/flash_bwd.cu: the tensor-core dkv kernel's bounds."""
    lo, hi = 0, -(-s // tile)
    if not causal:
        return lo, hi
    first = max(0, k0 - off)
    lo = first // tile
    if first >= s:
        hi = lo
    elif window is not None:
        top = min(k0 + tile, s) - 1 + window - 1 - off
        hi = 0 if top < 0 else min(hi, top // tile + 1)
    return lo, max(lo, hi)


def _strides(x):
    """``x``'s (batch, sequence, head) strides as the kernels take them:
    a dimension of size 1 is never stepped, so torch leaves its stride
    arbitrary (a dO at B 1 arrives with a batch stride of 1), and it gets
    the stride a dense layout would give it, which addresses the same
    bytes."""
    out = list(x.stride()[:4])
    for i in (2, 1, 0):
        if x.shape[i] == 1:
            out[i] = out[i + 1] * x.shape[i + 1]
    return out[:3]


def tensor_core_route(q, k, v, do=None):
    """True when the kernels' tensor-core route takes these operands (q,
    k, v, and for the backward dO): bf16, head dim 64 or 128, every base
    pointer 16-byte aligned and every (batch, sequence, head) stride
    (:func:`_strides`) a positive multiple of 8 elements (TMA's 16
    bytes). Everything else takes the CUDA-core loop. A rule on the
    operands alone, so the CPU tests check it."""
    if q.dtype != torch.bfloat16 or q.shape[3] not in (64, 128):
        return False
    ops = (q, k, v) if do is None else (q, k, v, do)
    return all(x.data_ptr() % 16 == 0
               and all(st > 0 and st % 8 == 0 for st in _strides(x))
               for x in ops)


def _kernel_args(q, k, v, causal, window, off=None):
    """What every launch checks and passes: sizes, (batch, sequence,
    head) strides of q, k, v, and the tail: the scale, then ``causal``
    for a static kernel or the band offset ``off``, then the window."""
    b, s, h, d = q.shape
    if d < 1:
        raise ValueError(f"the kernels take head_dim >= 1, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    # The pairs of a tile are at most (off + S - 1) apart, so a window of
    # off + S or more masks nothing more than causality does; the clamp
    # keeps the C int in range.
    reach = s if off is None else s + int(off)
    win = 0 if window is None else int(min(window, max(reach, 1)))
    strides = [st for x in (q, k, v) for st in _strides(x)]
    mode = int(causal) if off is None else int(off)
    return (b, s, h, k.shape[2], d), strides, (_scale(d), mode, win)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_fwd(name, q, k, v, causal, window, off=None):
    """(out, lse) of forward kernel ``name`` (static, or band at ``off``)
    on the route :func:`tensor_core_route` picks."""
    sizes, strides, tail = _kernel_args(q, k, v, causal, window, off)
    b, s, h, _, d = sizes
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b * s * h == 0:
        return out, lse
    _launch(name, (q, k, v), (out, lse), sizes, strides, tail)
    return out, lse


def _bwd_args(q, k, v, do, lse, delta, causal, window, off=None):
    """A backward launch's operands (q, k, v, dO, lse, delta; the kernels
    read lse and delta as dense (B, H, S), so a strided one is copied),
    sizes, strides and tail. The caller holds the operands until the
    launch is enqueued: a copy freed before it would return its block to
    the allocator, which may hand it to the outputs the kernel writes."""
    sizes, strides, tail = _kernel_args(q, k, v, causal, window, off)
    if do.stride(3) != 1:
        raise ValueError("dO must have a contiguous head dim")
    strides += _strides(do)
    ops = (q, k, v, do, lse.contiguous(), delta.contiguous())
    return ops, sizes, strides, tail


def _ptrs(tensors):
    return [x.data_ptr() for x in tensors]


def wgmma_smem_bytes(name, d):
    """Dynamic shared memory, in bytes, of the tensor-core kernel of
    ``name`` ("flash_fwd", "flash_bwd_dq" or "flash_bwd_dkv"; the band
    kernels share them) at head dim ``d``; 0 where the route does not
    take ``d``."""
    if name == "flash_fwd":
        return _kernel_lib("flash_fwd").hvd_flash_fwd_wgmma_smem(d)
    return _kernel_lib("flash_bwd").hvd_flash_bwd_wgmma_smem(
        int(name == "flash_bwd_dkv"), d)


def _launch(name, ops, outs, sizes, strides, tail):
    """Launch kernel ``name`` on the route :func:`tensor_core_route`
    picks for its operands, and count it on that route. ``ops`` (q, k,
    v, and for the backward dO, lse and delta as :func:`_bwd_args`
    returns them; held by the caller through the launch), ``outs`` the
    tensors it writes."""
    tc = tensor_core_route(*ops[:4])
    q = ops[0]
    _call(_KERNELS[name][0], f"hvd_{name}{'_wgmma' if tc else ''}",
          *_ptrs(ops), *_ptrs(outs), _DTYPES[q.dtype], *sizes, *strides,
          *tail, _stream(q))
    globals()[_COUNTERS[name][tc]] += 1
    if _flops is not None:
        _flops[0] += _launch_flops(name, sizes, tail)


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")
    return q.device.type


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, window=None):
    """dQ (B, S, H, D) in q's dtype from the forward's inputs, the output
    cotangent ``do``, the saved ``lse`` and ``delta`` (both (B, H, S)
    f32): the ``flash_bwd_dq`` kernel on a CUDA tensor, its plain version
    on a CPU one."""
    if _device_of(q) == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, window)
    _check_bwd(q, k, v, do, lse, delta, causal, window)
    ops, sizes, strides, tail = _bwd_args(q, k, v, do, lse, delta, causal,
                                          window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    _launch("flash_bwd_dq", ops, (dq,), sizes, strides, tail)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, window=None):
    """(dK, dV), each (B, S, H_kv, D) in k's dtype and summed over each
    GQA group: the ``flash_bwd_dkv`` kernel on a CUDA tensor, its plain
    version on a CPU one. Arguments as :func:`flash_bwd_dq`."""
    if _device_of(q) == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                       window)
    _check_bwd(q, k, v, do, lse, delta, causal, window)
    ops, sizes, strides, tail = _bwd_args(q, k, v, do, lse, delta, causal,
                                          window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    _launch("flash_bwd_dkv", ops, (dk, dv), sizes, strides, tail)
    return dk, dv


def _tile_lse(q, k, v, causal, window):
    """(out in q's dtype, lse (B, H, S) f32) of a static-offset tile: the
    whole sequence for :func:`flash_attention`, the diagonal (causal,
    window) or a fully visible (non-causal) tile for the ring. The
    ``flash_fwd`` kernel on a CUDA tensor, its plain version on a CPU
    one. The JAX package's ``_tile_lse`` takes a dense path on ragged
    lengths; the kernel masks the edge itself."""
    _check(q, k, v, causal, window)
    if _device_of(q) == "cpu":
        return flash_attention_reference(q, k, v, causal, window)
    return _launch_fwd("flash_fwd", q, k, v, causal, window)


def flash_band_fwd(q, k, v, off, window=None):
    """(out (B, S, H, D) in q's dtype, lse (B, H, S) f32) of ring
    attention's band tile: q's row i sits at position ``off + i`` after
    the origin of the visiting k/v, causal and windowed at that offset.
    The ``flash_band_fwd`` kernel on a CUDA tensor, its plain version on
    a CPU one. Not differentiable: ring attention's backward calls
    :func:`flash_band_dq` and :func:`flash_band_dkv` itself."""
    _check(q, k, v, True, window)
    if _device_of(q) == "cpu":
        return flash_band_fwd_reference(q, k, v, off, window)
    return _launch_fwd("flash_band_fwd", q, k, v, True, window, off)


def flash_band_dq(q, k, v, do, lse, delta, off, window=None):
    """f32 dQ (B, S, H, D) of the band tile at offset ``off`` from the
    ring's global ``lse`` and ``delta`` (both (B, H, S) f32, lse finite
    for every row): the ``flash_band_dq`` kernel on a CUDA tensor, its
    plain version on a CPU one."""
    if _device_of(q) == "cpu":
        return flash_band_dq_reference(q, k, v, do, lse, delta, off, window)
    _check_bwd(q, k, v, do, lse, delta, True, window)
    ops, sizes, strides, tail = _bwd_args(q, k, v, do, lse, delta, True,
                                          window, off)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq
    _launch("flash_band_dq", ops, (dq,), sizes, strides, tail)
    return dq


def flash_band_dkv(q, k, v, do, lse, delta, off, window=None):
    """f32 (dK, dV), each (B, S, H_kv, D) and summed over each GQA group,
    of the band tile at offset ``off``: the ``flash_band_dkv`` kernel on a
    CUDA tensor, its plain version on a CPU one. Arguments as
    :func:`flash_band_dq`."""
    if _device_of(q) == "cpu":
        return flash_band_dkv_reference(q, k, v, do, lse, delta, off, window)
    _check_bwd(q, k, v, do, lse, delta, True, window)
    ops, sizes, strides, tail = _bwd_args(q, k, v, do, lse, delta, True,
                                          window, off)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    _launch("flash_band_dkv", ops, (dk, dv), sizes, strides, tail)
    return dk, dv


def _tile_bwd_dispatch(q, k, v, g, lse, delta, off, causal, window):
    """f32 (dq, dk, dv) of one ring tile from the ring's global ``lse``
    and ``delta`` (B, H, S), dk/dv at the K/V head count: the static
    kernels for the diagonal (``off`` None, offset 0) and fully visible
    (``causal`` False) tiles, whose gradients come out in q's dtype and
    only then become f32, as in the JAX package; the band kernels for a
    tile at offset ``off``. The band kernels need ``lse`` finite for every
    row; the ring guarantees it, since each row's diagonal tile holds its
    own key."""
    if off is not None:
        dq = flash_band_dq(q, k, v, g, lse, delta, off, window)
        dk, dv = flash_band_dkv(q, k, v, g, lse, delta, off, window)
        return dq, dk, dv
    window = window if causal else None
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal, window)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal, window)
    return dq.float(), dk.float(), dv.float()


class _FlashAttention(torch.autograd.Function):
    """(out, lse) with the flash backward: the custom VJP of the JAX
    package's ``flash_attention_with_lse``; ``flash_attention`` uses the
    same function and leaves the lse cotangent undefined."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _tile_lse(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        g_out = g_out.contiguous()
        # delta = rowsum(dO * O) in f32 from the stored values; the lse
        # cotangent enters dS in delta's slot with the opposite sign.
        delta = (g_out.float() * out.float()).sum(dim=-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse.float()
        delta = delta.contiguous()
        dq = flash_bwd_dq(q, k, v, g_out, lse, delta, ctx.causal, ctx.window)
        dk, dv = flash_bwd_dkv(q, k, v, g_out, lse, delta, ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, window=None):
    """Fused attention: (B, S, H, D) in q's dtype, differentiable in q, k
    and v."""
    return _FlashAttention.apply(q, k, v, causal, window)[0]


def flash_attention_with_lse(q, k, v, causal=True, window=None):
    """Like :func:`flash_attention`, also returning the per-row
    log-sum-exp shaped (B, H, S), f32; both outputs are
    differentiable."""
    return _FlashAttention.apply(q, k, v, causal, window)


def paged_attention_decode(q, k_pages, v_pages, page_table, lengths):
    """Single-token decode attention over a paged KV cache (one layer).

    q (B, 1, H, D); k_pages/v_pages (P, page, H_kv, D); page_table
    (B, pages_per_seq) integer page ids, unused slots at the null page 0;
    lengths (B,) visible tokens including the one just written. Returns
    (B, 1, H, D) in q's dtype. The gather is layout only; the row math is
    ``dense_attention``'s: the q.k product in f32 from the input values,
    the f32 ``1/sqrt(D)``, the ``NEG_INF`` fill past each length, an f32
    softmax, and p cast to v's dtype before an f32-accumulated p.v."""
    b = q.shape[0]
    k = k_pages[page_table].reshape(b, -1, k_pages.shape[2], k_pages.shape[3])
    v = v_pages[page_table].reshape(b, -1, v_pages.shape[2], v_pages.shape[3])
    rep = gqa_group(q.shape[2], k.shape[2], v.shape[2])
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    # The f32 scale as a Python number: a host tensor moved to the card
    # would be a copy that a CUDA graph cannot capture.
    scale = float(f32_scale(q.shape[3]))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    idx = torch.arange(s.shape[3], device=q.device)
    s = torch.where(idx < lengths[:, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p[:, :, 0].to(v.dtype).float(),
                       v.float())
    return out[:, None].to(q.dtype)
