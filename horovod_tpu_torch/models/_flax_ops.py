"""The Flax semantics the port's vision models need and torch lacks,
written once: TF/Flax ``SAME`` padding, Flax's pooling, Flax's
``BatchNorm``, its layers with Flax's parameter names, LeCun-normal
initialisation, and the converters between a Flax variable tree and a
module.

- ``SAME`` pads ``max(0, (ceil(n / s) - 1) * s + k - n)`` cells, the
  smaller half first: on an even input a 3x3/s2 conv pads (0, 1) and a
  7x7/s2 conv (2, 3), where torch's ``padding=`` is symmetric.
  :func:`same_pads` is the rule, :func:`same_pad` applies it.
- :class:`BatchNorm` is ``flax.linen.BatchNorm`` with
  ``use_fast_variance``: the batch statistics are ``mean(x)`` and
  ``max(0, mean(x^2) - mean(x)^2)`` in f32 (the biased variance), the
  running averages ``ra = momentum * ra + (1 - momentum) * batch`` of
  both (Flax ``momentum=0.9`` is torch's ``momentum=0.1``, and torch
  keeps the unbiased variance in its running stats, so ``nn.BatchNorm2d``
  is not this function). It normalises in f32 and casts to ``dtype``.
- :class:`Conv` and :class:`Dense` cast input and weight to ``dtype``
  per call, as ``nn.Conv(dtype=...)`` does with its f32 parameter.

Names follow Flax: a module's parameters are ``kernel``, ``bias`` and
``scale``, its running statistics ``mean`` and ``var``, and the models
name their submodules as Flax names them (``Conv_0``, ``BatchNorm_1``,
``proj_bn``, ...). So :func:`params_from_jax` and :func:`params_to_numpy`
walk the module by name: a conv kernel is HWIO in Flax and OIHW here, a
dense kernel ``(in, out)`` there and ``(out, in)`` here, and
``batch_stats`` are the modules' buffers. The layout is NCHW.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size, kernel, stride):
    """(low, high) padding of one spatial dim under TF/Flax ``SAME``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def same_pad(x, kernel, stride, value=0.0):
    """``x`` (N, C, H, W) padded as ``SAME`` pads it for a ``kernel``
    (kh, kw) window at ``stride`` (sh, sw), the extra row and column at
    the bottom and right, with ``value``."""
    (kh, kw), (sh, sw) = _pair(kernel), _pair(stride)
    top, bottom = same_pads(x.shape[2], kh, sh)
    left, right = same_pads(x.shape[3], kw, sw)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _pair(x):
    return (x, x) if isinstance(x, int) else tuple(x)


def max_pool(x, window, stride, padding="VALID"):
    """``nn.max_pool``: SAME pads with -inf, so a padded cell never wins."""
    if padding == "SAME":
        x = same_pad(x, window, stride, value=-math.inf)
    return F.max_pool2d(x, window, stride)


def avg_pool_same(x, window=3):
    """``nn.avg_pool(x, (w, w), strides=(1, 1), padding="SAME",
    count_include_pad=False)``: padded cells count in neither the sum nor
    the divisor. At stride 1 and an odd window SAME is symmetric."""
    return F.avg_pool2d(x, window, 1, padding=window // 2,
                        count_include_pad=False)


def lecun_normal_(w, fan_in, generator):
    """Flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in (``variance_scaling(1,
    "fan_in", "truncated_normal")``), drawn from ``generator``."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    # inverse-CDF sampling of the standard normal within [-2, 2], as
    # nn.init.trunc_normal_ does, in fewer passes
    edge = math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        w.uniform_(-edge, edge, generator=generator).erfinv_()
        w.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)
    return w


class Conv(nn.Module):
    """``nn.Conv(features, kernel, strides, padding, use_bias, dtype)``
    on NCHW: kernel (O, I, kh, kw) in f32, input and kernel cast to
    ``dtype``."""

    def __init__(self, in_ch, features, kernel, strides=1, padding="SAME",
                 use_bias=False, dtype=torch.bfloat16, generator=None):
        super().__init__()
        kh, kw = _pair(kernel)
        self.strides, self.padding, self.dtype = _pair(strides), padding, \
            dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(features, in_ch, kh, kw), in_ch * kh * kw,
            generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        kh, kw = self.kernel.shape[2:]
        pad = 0
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], kh, self.strides[0])
            pw = same_pads(x.shape[3], kw, self.strides[1])
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])      # symmetric: the conv pads
            else:
                x = F.pad(x, (*pw, *ph))  # (0, 1) and (2, 3): pad first
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.kernel.to(self.dtype), bias,
                        self.strides, pad)


class Dense(nn.Module):
    """``nn.Dense(features, dtype)``: kernel (out, in) in f32, bias."""

    def __init__(self, in_features, features, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(features, in_features), in_features, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype),
                        self.bias.to(self.dtype))


def dropout(x, rate, generator):
    """``nn.Dropout(rate)`` in training: keep each element with
    probability 1 - rate and divide the kept ones by it, the draws from
    ``generator`` (Flax raises without a dropout rng; so does this)."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a generator (dropout_generator=)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class _BatchNormTrain(torch.autograd.Function):
    """Flax's training-mode normalisation of x (N, C, H, W) over (N, H, W)
    in f32, returning (y in ``dtype``, batch mean, biased batch var). The
    backward is the gradient of that function (of the fast variance too:
    d var / dx = 2 (x - mean) / n either way), in f32, its input's
    gradient cast to x's dtype as JAX's transpose of the f32 cast does."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, dtype):
        dims = (0, 2, 3)
        xf = x.float()
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        mul = (rstd * scale)[None, :, None, None]
        y = ((xf - mean[None, :, None, None]) * mul
             + bias[None, :, None, None]).to(dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, rstd = ctx.saved_tensors
        dims = (0, 2, 3)
        n = x.numel() // x.shape[1]
        xhat = (x.float() - mean[None, :, None, None]) \
            * rstd[None, :, None, None]
        dyf = dy.float()
        dbias = dyf.sum(dims)
        dscale = (dyf * xhat).sum(dims)
        dx = (scale * rstd)[None, :, None, None] * (
            dyf - (dbias / n)[None, :, None, None]
            - xhat * (dscale / n)[None, :, None, None])
        return dx.to(x.dtype), dscale, dbias, None, None


class BatchNorm(nn.Module):
    """``nn.BatchNorm(momentum, epsilon, dtype, param_dtype=f32)`` over
    the channels of NCHW input. In training mode (``self.training``) it
    normalises by the batch's statistics and folds them into ``mean`` and
    ``var``; in eval mode by ``mean`` and ``var``."""

    def __init__(self, features, momentum=0.9, epsilon=1e-5,
                 dtype=torch.bfloat16, scale_init=1.0):
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.scale = nn.Parameter(torch.full((features,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training:
            y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                                 self.epsilon, self.dtype)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.var.mul_(m).add_(var, alpha=1.0 - m)
            return y
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale
        return ((x.float() - self.mean[None, :, None, None])
                * mul[None, :, None, None]
                + self.bias[None, :, None, None]).to(self.dtype)


def _leaves(module):
    """{dotted name: tensor} of the module's parameters and buffers."""
    out = dict(module.named_parameters())
    out.update(module.named_buffers())
    return out


def _flax_leaf(name):
    """(collection, keys) of a module leaf in a Flax variable tree."""
    keys = name.split(".")
    return ("batch_stats" if keys[-1] in ("mean", "var") else "params"), keys


def _to_flax_layout(t):
    if t.dim() == 4:        # OIHW -> HWIO
        return t.permute(2, 3, 1, 0)
    if t.dim() == 2:        # (out, in) -> (in, out)
        return t.t()
    return t


def params_from_jax(module, variables):
    """Load a Flax variable tree (``{"params": ..., "batch_stats": ...}``,
    leaves numpy arrays or anything ``np.asarray`` takes) into
    ``module`` in place, leaf by leaf by name: conv kernels HWIO -> OIHW,
    dense kernels (in, out) -> (out, in), ``batch_stats`` into the
    buffers. Raises on a missing or extra leaf or a shape mismatch.
    Returns ``module``."""
    seen = set()
    with torch.no_grad():
        for name, t in _leaves(module).items():
            coll, keys = _flax_leaf(name)
            node = variables.get(coll, {})
            for k in keys:
                if not isinstance(node, dict) or k not in node:
                    raise KeyError(f"{coll}/{'/'.join(keys)} is missing "
                                   "from the Flax variables")
                node = node[k]
            want = tuple(_to_flax_layout(t).shape)
            x = np.asarray(node)
            if x.shape != want:
                raise ValueError(f"{coll}/{'/'.join(keys)}: shape "
                                 f"{x.shape}, expected {want}")
            src = torch.from_numpy(np.array(x, dtype=np.float32))
            _to_flax_layout(t).copy_(src)
            seen.add((coll, tuple(keys)))
    extra = [f"{coll}/{'/'.join(path)}"
             for coll in ("params", "batch_stats")
             for path in _paths(variables.get(coll, {}))
             if (coll, path) not in seen]
    if extra:
        raise KeyError(f"Flax leaves with no counterpart in the module: "
                       f"{extra[:5]}")
    return module


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def params_to_numpy(module):
    """The module's parameters and running statistics as a Flax variable
    tree of numpy arrays (copies), in Flax's layouts: what
    :func:`params_from_jax` reads back."""
    out = {}
    for name, t in _leaves(module).items():
        coll, keys = _flax_leaf(name)
        node = out.setdefault(coll, {})
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _to_flax_layout(t.detach()).float().cpu() \
            .numpy().copy()
    return out
