"""Inception V3 — the reference's top published scaling workload.

Counterpart of horovod_tpu/models/inception.py in NCHW: the slim/keras
geometry (299x299x3 -> 8x8x2048, ``VALID`` in the stem and the grid
reductions, ``SAME`` inside the blocks), ``ConvBN`` units (conv without
bias, Flax BatchNorm with eps 1e-3, ReLU), average pools that exclude
padding, dropout and an f32 head; bf16 compute with f32 parameters.

Flax names a module when it is constructed, and in
``conv(96, (3, 3))(conv(96, (3, 3))(conv(64, (1, 1))(x)))`` Python
constructs the outer unit first: it gets the lowest ``ConvBN_i`` index,
and the innermost one, which runs first, the highest. So the
architecture is written once, in :func:`_body`, with the reference's
nesting, and run twice: at construction with channel counts, to create
the units in the order Python evaluates the ``conv(...)`` calls (and
learn each one's input width), and in ``forward`` with tensors, taking
the units in that same order. The units are then ``ConvBN_0`` ..
``ConvBN_93`` as in the reference's tree, and ``params_from_jax``
converts it by name.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.devices import resolve_device
from ._flax_ops import BatchNorm, Conv, Dense, avg_pool_same, dropout, \
    max_pool
from ._flax_ops import params_from_jax, params_to_numpy  # noqa: F401


class ConvBN(nn.Module):
    """conv + BatchNorm + ReLU, the Inception 'BasicConv2d' unit."""

    def __init__(self, in_ch, filters, kernel, strides=1, padding="SAME",
                 dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, kernel, strides, padding,
                           dtype=dtype, generator=generator)
        self.BatchNorm_0 = BatchNorm(filters, 0.9, 1e-3, dtype)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _body(conv, x, pool, avg, cat):
    """The reference's trunk, with its nesting: ``conv(filters, kernel,
    strides, padding)`` returns a unit to apply, ``pool`` is the 3x3/s2
    VALID max-pool, ``avg`` the 3x3 SAME average pool, ``cat`` the
    channel concatenation."""
    # Stem: 299 -> 35x35x192
    x = conv(32, (3, 3), strides=2, padding="VALID")(x)
    x = conv(32, (3, 3), padding="VALID")(x)
    x = conv(64, (3, 3))(x)
    x = pool(x)
    x = conv(80, (1, 1), padding="VALID")(x)
    x = conv(192, (3, 3), padding="VALID")(x)
    x = pool(x)

    # 3x Inception-A (35x35), pool-branch width 32 then 64, 64
    for pool_ch in (32, 64, 64):
        b1 = conv(64, (1, 1))(x)
        b5 = conv(64, (5, 5))(conv(48, (1, 1))(x))
        b3 = conv(96, (3, 3))(conv(96, (3, 3))(conv(64, (1, 1))(x)))
        bp = conv(pool_ch, (1, 1))(avg(x))
        x = cat([b1, b5, b3, bp])

    # Grid reduction A: 35 -> 17
    b3 = conv(384, (3, 3), strides=2, padding="VALID")(x)
    bd = conv(96, (3, 3), strides=2, padding="VALID")(
        conv(96, (3, 3))(conv(64, (1, 1))(x)))
    bp = pool(x)
    x = cat([b3, bd, bp])

    # 4x Inception-B (17x17) with factorized 1x7/7x1, c7 widths per slim
    for c7 in (128, 160, 160, 192):
        b1 = conv(192, (1, 1))(x)
        b7 = conv(192, (7, 1))(conv(c7, (1, 7))(conv(c7, (1, 1))(x)))
        bd = conv(c7, (1, 1))(x)
        bd = conv(c7, (1, 7))(conv(c7, (7, 1))(bd))
        bd = conv(192, (1, 7))(conv(c7, (7, 1))(bd))
        bp = conv(192, (1, 1))(avg(x))
        x = cat([b1, b7, bd, bp])

    # Grid reduction B: 17 -> 8
    b3 = conv(320, (3, 3), strides=2, padding="VALID")(
        conv(192, (1, 1))(x))
    b7 = conv(192, (7, 1))(conv(192, (1, 7))(conv(192, (1, 1))(x)))
    b7 = conv(192, (3, 3), strides=2, padding="VALID")(b7)
    bp = pool(x)
    x = cat([b3, b7, bp])

    # 2x Inception-C (8x8) with split 1x3/3x1 fan-outs
    for _ in range(2):
        b1 = conv(320, (1, 1))(x)
        b3 = conv(384, (1, 1))(x)
        b3 = cat([conv(384, (1, 3))(b3), conv(384, (3, 1))(b3)])
        bd = conv(384, (3, 3))(conv(448, (1, 1))(x))
        bd = cat([conv(384, (1, 3))(bd), conv(384, (3, 1))(bd)])
        bp = conv(192, (1, 1))(avg(x))
        x = cat([b1, b3, bd, bp])
    return x


class InceptionV3(nn.Module):
    def __init__(self, num_classes=1000, dtype=torch.bfloat16,
                 dropout_rate=0.5, generator=None, device="cuda"):
        super().__init__()
        self.dtype, self.dropout_rate = dtype, dropout_rate
        specs = []  # (filters, kernel, strides, padding, in_ch) by index

        def spec_conv(filters, kernel, strides=1, padding="SAME"):
            i = len(specs)
            specs.append(None)

            def apply(in_ch):
                specs[i] = (filters, kernel, strides, padding, in_ch)
                return filters
            return apply

        width = _body(spec_conv, 3, lambda c: c, lambda c: c, sum)
        for i, (filters, kernel, strides, padding, in_ch) in \
                enumerate(specs):
            self.add_module(f"ConvBN_{i}", ConvBN(
                in_ch, filters, kernel, strides, padding, dtype, generator))
        self.n_units = len(specs)
        self.Dense_0 = Dense(width, num_classes, torch.float32, generator)
        self.to(resolve_device(device))

    def forward(self, x, dropout_generator=None):
        units = iter(range(self.n_units))

        def conv(*_args, **_kw):
            return getattr(self, f"ConvBN_{next(units)}")

        x = _body(conv, x.to(self.dtype), lambda t: max_pool(t, 3, 2),
                  avg_pool_same, lambda ts: torch.cat(ts, dim=1))
        # jnp.mean of bf16 sums in f32 and returns bf16
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        if self.training:
            x = dropout(x, self.dropout_rate, dropout_generator)
        return self.Dense_0(x.float())
