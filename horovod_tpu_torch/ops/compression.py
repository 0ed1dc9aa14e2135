"""Gradient compression for the collective wire.

Counterpart of horovod_tpu/ops/compression.py and of the torch binding's
compressors (horovod_tpu/torch/__init__.py): a ``Compressor`` interface
and the ``Compression`` namespace. On a card 16 bits on the wire can be
either half format, so ``Compression.fp16`` is IEEE fp16, as in the
reference Horovod and the JAX package's torch binding (the JAX package
itself maps ``fp16`` to bf16, the TPU's native half format), and
``Compression.bf16`` is bfloat16. Int8 waits for ROADMAP.md, Queue 1
item 3.
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
    """The JAX package's 8-bit wire format; not ported yet."""

    MESSAGE = "Int8 compression is not ported yet (ROADMAP.md, Queue 1 item 3)"

    @classmethod
    def compress(cls, tensor):
        raise NotImplementedError(cls.MESSAGE)

    @classmethod
    def decompress(cls, tensor, ctx):
        raise NotImplementedError(cls.MESSAGE)


class Compression:
    """Optional gradient compression algorithm used during allreduce."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
