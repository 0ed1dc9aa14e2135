"""VGG-16 — a headline scaling-benchmark workload of the reference.

Counterpart of horovod_tpu/models/vgg.py in NCHW: 3x3 ``SAME`` convs
with bias and ReLU, a 2x2/2 max-pool after each stage, two 4096-wide
``Dense`` + ReLU + dropout, and an f32 head; bf16 compute with f32
parameters. Parameters are named as Flax names them (``Conv_0`` ..
``Conv_12``, ``Dense_0`` .. ``Dense_2``).

The reference flattens NHWC activations, so the first 4096-wide layer
reads its input in (H, W, C) order. This module flattens in that order
too (a permute before the reshape), so a Flax kernel converts with the
plain (in, out) -> (out, in) transpose and no row permutation. Dropout
draws from the ``dropout_generator`` passed to ``forward`` (Flax's
``rngs={"dropout": key}``); training with a positive rate needs one.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.devices import resolve_device
from ._flax_ops import Conv, Dense, dropout, max_pool
from ._flax_ops import params_from_jax, params_to_numpy  # noqa: F401

# (filters, repeats) per stage; a 2x2/2 max-pool follows each stage.
_VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG(nn.Module):
    """``image_size`` fixes the first ``Dense``'s fan-in, as the
    reference's ``init`` shape does."""

    def __init__(self, stages=_VGG16_STAGES, num_classes=1000,
                 dtype=torch.bfloat16, dropout_rate=0.5, image_size=224,
                 generator=None, device="cuda"):
        super().__init__()
        self.stages, self.dtype, self.dropout_rate = stages, dtype, \
            dropout_rate
        in_ch, n, size = 3, 0, image_size
        for filters, repeats in stages:
            for _ in range(repeats):
                self.add_module(f"Conv_{n}", Conv(in_ch, filters, 3, 1,
                                                  use_bias=True, dtype=dtype,
                                                  generator=generator))
                in_ch, n = filters, n + 1
            size //= 2
        width = in_ch * size * size
        for i in range(2):
            self.add_module(f"Dense_{i}", Dense(width, 4096, dtype,
                                                generator))
            width = 4096
        self.Dense_2 = Dense(width, num_classes, torch.float32, generator)
        self.to(resolve_device(device))

    def forward(self, x, dropout_generator=None):
        x = x.to(self.dtype)
        n = 0
        for _, repeats in self.stages:
            for _ in range(repeats):
                x = F.relu(getattr(self, f"Conv_{n}")(x))
                n += 1
            x = max_pool(x, 2, 2)
        # the reference's NHWC flatten order: (H, W, C)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i in range(2):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            if self.training:
                x = dropout(x, self.dropout_rate, dropout_generator)
        return self.Dense_2(x.float())


def VGG16(num_classes=1000, dtype=torch.bfloat16, dropout_rate=0.5,
          image_size=224, generator=None, device="cuda"):
    return VGG(_VGG16_STAGES, num_classes, dtype, dropout_rate, image_size,
               generator, device)
