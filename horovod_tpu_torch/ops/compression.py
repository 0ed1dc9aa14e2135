"""Gradient compression for the collective wire.

Counterpart of horovod_tpu/ops/compression.py and of the torch binding's
compressors (horovod_tpu/torch/__init__.py): a ``Compressor`` interface
and the ``Compression`` namespace. On a card 16 bits on the wire can be
either half format, so ``Compression.fp16`` is IEEE fp16, as in the
reference Horovod and the JAX package's torch binding (the JAX package
itself maps ``fp16`` to bf16, the TPU's native half format), and
``Compression.bf16`` is bfloat16. ``Compression.int8`` is the JAX
package's 8-bit linear code (:class:`Int8Compressor`), the wire format of
the DCN stage of the staged exchange (ops/collectives.py
``dcn_staged_psum_scatter``), where every rank of the group quantizes on
one shared scale.
"""

import torch


class Compressor:
    """Interface for compressing/decompressing a tensor on the wire."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """No-op compression."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _HalfCompressor(Compressor):
    """Downcast floating tensors to a 16-bit wire dtype and restore the
    input dtype after the collective."""

    WIRE_DTYPE = torch.bfloat16

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            tensor = tensor.to(cls.WIRE_DTYPE)
        return tensor, ctx

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None and ctx.is_floating_point:
            tensor = tensor.to(ctx)
        return tensor


class FP16Compressor(_HalfCompressor):
    WIRE_DTYPE = torch.float16


class BF16Compressor(_HalfCompressor):
    WIRE_DTYPE = torch.bfloat16


class Int8Compressor(Compressor):
    """8-bit linear quantization with a per-tensor (per-bucket) scale:
    ``codes = round(x / scale)`` clipped to [-127, 127] with
    ``scale = max|x| / 127``, so the wire carries one int8 per element
    plus one scalar. ``torch.round`` rounds half to even, as
    ``jnp.round`` does.

    The staged exchange quantizes on a scale shared by its DCN group (an
    all-reduce ``MAX`` of the max-abs), so the summed codes dequantize
    exactly. The standalone ``compress``/``decompress`` here use the
    local per-tensor scale and are not safe around a plain sum, whose
    ranks would each use their own scale (the JAX package's docstring
    says so, horovod_tpu/ops/compression.py:100-106): so
    ``DistributedOptimizer(compression=Compression.int8)`` is refused,
    and int8 is reached through ``dcn_compression="int8"``."""

    WIRE_DTYPE = torch.int8
    MESSAGE = ("Compression.int8 uses a per-rank scale, which a plain "
               "all-reduce cannot sum (horovod_tpu/ops/compression.py:"
               "100-106): use dcn_compression='int8', whose DCN stage "
               "quantizes on a scale shared by the group")

    @staticmethod
    def scale_for(amax):
        """Quantization step for a max-abs value (a tensor), guarded
        against the all-zero bucket: ``max(amax, 1e-30) / 127`` in the
        dtype of ``amax``, as the JAX package's weak-typed constants
        keep it (f32 in the exchange)."""
        return torch.clamp_min(amax, 1e-30) / 127.0

    @classmethod
    def quantize(cls, tensor, scale):
        """Codes (in ``tensor``'s float dtype) on a caller-supplied,
        possibly group-shared, grid."""
        return torch.clamp(torch.round(tensor / scale), -127, 127)

    @staticmethod
    def dequantize(codes, scale, dtype):
        return (codes * scale).to(dtype)

    @classmethod
    def compress(cls, tensor):
        if not tensor.is_floating_point():
            return tensor, (tensor.dtype, None)
        scale = cls.scale_for(tensor.abs().max())
        codes = cls.quantize(tensor.float(), scale)
        return codes.to(cls.WIRE_DTYPE), (tensor.dtype, scale)

    @classmethod
    def decompress(cls, tensor, ctx):
        dtype, scale = ctx
        if scale is None:
            return tensor
        return cls.dequantize(tensor.float(), scale, dtype)

    @classmethod
    def wire_dtype(cls, dtype):
        return cls.WIRE_DTYPE if dtype.is_floating_point else dtype


class Compression:
    """Optional gradient compression algorithm used during allreduce."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
