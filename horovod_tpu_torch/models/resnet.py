"""ResNet v1.5 — the benchmark workload of ``bench/resnet.py``.

Counterpart of horovod_tpu/models/resnet.py, in NCHW (on a card the
bench runs it ``torch.channels_last``, cuDNN's fast layout). The same
function, parameter for parameter:

- the stride of a downsampling bottleneck sits on its 3x3 conv (v1.5),
  with Flax ``SAME`` padding: (0, 1) on an even input, not torch's (1, 1);
- the stem is the space-to-depth one by default (``conv_init_s2d``, a
  4x4/s1 conv over the 2x2 blocks of the input padded (2, 4), channels
  ordered (dh, dw, c)), which computes the 7x7/s2 ``SAME`` conv exactly;
  ``space_to_depth=False`` keeps the literal ``conv_init``, padded (2, 3);
- the 3x3/s2 max-pool pads ``SAME`` with -inf;
- Flax's BatchNorm (``_flax_ops.BatchNorm``: momentum 0.9, eps 1e-5, the
  biased variance in the running stats), the third of each block with
  its scale initialised to 0;
- bf16 compute with f32 parameters, the global mean pool accumulated in
  f32 and rounded to bf16 as ``jnp.mean`` does, and the classifier head
  in f32.

Convolutions run as ``F.conv2d`` (cuDNN on a card): the reference has no
hand kernel for them, XLA emits them. Submodules carry Flax's names
(``BottleneckBlock_3.Conv_1``, ``bn_init``, ``Dense_0``), so
``params_from_jax`` and ``params_to_numpy`` convert a Flax variable tree
leaf for leaf.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.devices import resolve_device
from ._flax_ops import BatchNorm, Conv, Dense, max_pool
from ._flax_ops import params_from_jax, params_to_numpy  # noqa: F401


def space_to_depth(x, block=2):
    """(N, C, H, W) -> (N, b*b*C, H/b, W/b), channels ordered (dh, dw, c)
    as the NHWC reference orders them."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, block * block * c, h // block, w // block)


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch, filters, strides=1, dtype=torch.bfloat16,
                 generator=None):
        super().__init__()

        def conv(i, o, k, s=1):
            return Conv(i, o, k, s, dtype=dtype, generator=generator)

        def norm(c, **kw):
            return BatchNorm(c, 0.9, 1e-5, dtype, **kw)

        self.Conv_0 = conv(in_ch, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, 1)
        self.BatchNorm_2 = norm(filters * 4, scale_init=0.0)
        if in_ch != filters * 4 or strides != 1:
            self.proj = conv(in_ch, filters * 4, 1, strides)
            self.proj_bn = norm(filters * 4)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if hasattr(self, "proj"):
            residual = self.proj_bn(self.proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 over ``stage_sizes`` bottleneck blocks a stage. Train
    and eval mode are torch's (``model.train()``, ``model.eval()``):
    Flax's ``train=True`` and ``train=False``."""

    def __init__(self, stage_sizes, num_classes=1000, width=64,
                 dtype=torch.bfloat16, space_to_depth=True, generator=None,
                 device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.space_to_depth = space_to_depth
        if space_to_depth:
            self.conv_init_s2d = Conv(12, width, 4, 1, "VALID", dtype=dtype,
                                      generator=generator)
        else:
            self.conv_init = Conv(3, width, 7, 2, dtype=dtype,
                                  generator=generator)
        self.bn_init = BatchNorm(width, 0.9, 1e-5, dtype)
        in_ch, n = width, 0
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = width * 2 ** i
                self.add_module(f"BottleneckBlock_{n}", BottleneckBlock(
                    in_ch, filters, 2 if i > 0 and j == 0 else 1, dtype,
                    generator))
                in_ch, n = filters * 4, n + 1
        self.n_blocks = n
        self.Dense_0 = Dense(in_ch, num_classes, torch.float32, generator)
        self.to(resolve_device(device))

    def forward(self, x):
        x = x.to(self.dtype)
        if self.space_to_depth:
            # The reference builds the literal stem for an odd input, so
            # its parameter tree would hold conv_init instead.
            if x.shape[2] % 2 or x.shape[3] % 2:
                raise ValueError(
                    f"the space-to-depth stem needs even H and W, got "
                    f"{tuple(x.shape[2:])}; use space_to_depth=False")
            # SAME of a 7x7/s2 conv pads (2, 3); one more bottom/right row
            # keeps the dims even for the 2x2 blocks, and meets only the
            # 8x8 kernel's zero row and column.
            x = space_to_depth(F.pad(x, (2, 4, 2, 4)), 2)
            x = self.conv_init_s2d(x)
        else:
            x = self.conv_init(x)
        x = F.relu(self.bn_init(x))
        x = max_pool(x, 3, 2, "SAME")
        for i in range(self.n_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x)
        # jnp.mean of bf16 sums in f32 and returns bf16
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.Dense_0(x.float())


def ResNet50(num_classes=1000, dtype=torch.bfloat16, space_to_depth=True,
             generator=None, device="cuda"):
    return ResNet((3, 4, 6, 3), num_classes, dtype=dtype,
                  space_to_depth=space_to_depth, generator=generator,
                  device=device)


def ResNet101(num_classes=1000, dtype=torch.bfloat16, space_to_depth=True,
              generator=None, device="cuda"):
    return ResNet((3, 4, 23, 3), num_classes, dtype=dtype,
                  space_to_depth=space_to_depth, generator=generator,
                  device=device)


def s2d_kernel(w7):
    """The ``conv_init_s2d`` kernel (W, 12, 4, 4) that computes the 7x7
    stem kernel ``w7`` (W, 3, 7, 7): zero-padded to 8x8 and rearranged
    into the 2x2 blocks' (dh, dw, c) channels."""
    o, c = w7.shape[:2]
    w8 = F.pad(w7, (0, 1, 0, 1))
    w8 = w8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return w8.reshape(o, 4 * c, 4, 4)
