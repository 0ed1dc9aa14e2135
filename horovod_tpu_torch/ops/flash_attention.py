"""Fused attention forward on Hopper, and paged decode attention.

Counterpart of horovod_tpu/ops/flash_attention.py. The TPU kernel
``_fwd_kernel`` (Pallas) becomes a CUDA C++ kernel for sm_90a,
``ops/csrc/flash_fwd.cu``, built at first use (ops/_build.py) and called
through a plain C interface. Same contract as the JAX package: q
(B, S, H, D), k/v (B, S, H_kv, D) with H % H_kv == 0, causal by default,
optional sliding ``window`` (requires causal).

On a CUDA tensor the wrappers launch the kernel or raise; on a CPU
tensor they compute :func:`flash_attention_reference`, the plain
version of the same arithmetic. Ragged lengths need no special path on
the card: the kernel masks the edge itself, where the TPU kernel padded
causal lengths to a multiple of 128 and ran non-causal ones dense.

The backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) come
with the training slice (ROADMAP.md, Queue 1 item 5); until then a call
that needs gradients raises.

:func:`paged_attention_decode` is plain torch, as the JAX package runs
it as plain XLA with no Pallas kernel.
"""

import ctypes

import torch

from ..parallel.ring_attention import NEG_INF, f32_scale, gqa_group
from . import _build

# Launches of the CUDA kernel (one per wrapper call on the card). The
# plain version on the CPU does not count.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("flash_fwd")
        lib.hvd_flash_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.hvd_flash_fwd.restype = ctypes.c_int
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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


def flash_attention_reference(q, k, v, causal=True, window=None):
    """Plain version of the kernel: ``(out (B, S, H, D) in q's dtype,
    lse (B, H, S) f32)``, with ``_fwd_kernel``'s f32 arithmetic — q
    converted to f32 and scaled by ``1/sqrt(D)`` before the product,
    masked scores filled with ``NEG_INF``, ``l`` clamped at 1e-30 — taken
    over the whole row at once instead of tile by tile."""
    _check(q, k, v, causal, window)
    b, s, h, d = q.shape
    group = h // k.shape[2]
    qf = q.float() * _scale(d)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if causal:
        pos = torch.arange(s, device=q.device)
        keep = pos[:, None] >= pos[None, :]
        if window is not None:
            keep = keep & (pos[:, None] - pos[None, :] < window)
        sc = torch.where(keep, sc, NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l)


def _launch(q, k, v, causal, window):
    global launches
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention has no backward kernel yet; the training "
            "slice (ROADMAP.md, Queue 1 item 5) ports _bwd_dq_kernel and "
            "_bwd_dkv_kernel")
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    if not 1 <= d <= 128:
        raise ValueError(f"the kernel takes head_dim 1..128, got {d}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid (65535)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b * s * h == 0:
        return out, lse
    lib = _kernel_lib()
    err = lib.hvd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPES[q.dtype], b, s, h, h_kv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        _scale(d), int(causal), 0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "flash_fwd kernel launch failed: "
            f"{lib.hvd_cuda_error_string(err).decode()}")
    launches += 1
    return out, lse


def _forward(q, k, v, causal, window):
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _launch(q, k, v, causal, window)


def flash_attention(q, k, v, causal=True, window=None):
    """Fused attention forward: (B, S, H, D) in q's dtype."""
    return _forward(q, k, v, causal, window)[0]


def flash_attention_with_lse(q, k, v, causal=True, window=None):
    """Like :func:`flash_attention`, also returning the per-row
    log-sum-exp shaped (B, H, S), f32."""
    return _forward(q, k, v, causal, window)


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
    scale = f32_scale(q.shape[3]).to(q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    idx = torch.arange(s.shape[3], device=q.device)
    s = torch.where(idx < lengths[:, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p[:, :, 0].to(v.dtype).float(),
                       v.float())
    return out[:, None].to(q.dtype)
