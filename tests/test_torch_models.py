"""The port's vision models (horovod_tpu_torch/models: ResNet v1.5,
VGG, Inception V3, the MNIST MLP) against the JAX package's Flax ones.

The same variables go through both: the Flax module's are drawn by
``init``, their batch-norm parameters and running statistics replaced by
numpy draws from a seed (so that no block is a pass-through and eval mode
reads real statistics), and loaded into the port by
``params_from_jax``. The same numpy images go in as NHWC to Flax and as
NCHW to the port.

Tolerances, f32 (both sides exact f32; they differ in summation order
only): logits ``rtol = atol = 1e-4``; every parameter gradient 1e-4 in
relative L2; the running statistics after one train step 1e-5; the
parameters after 3 SGD(0.01) steps 1e-5 in relative L2 (where the
reference's own f32 is ill-conditioned, against the reference run in
f64: the ResNet's gradients and Inception in train mode, each test says
why). Readings on the CPU are noted beside each check. bf16: one ResNet case, its logits within
a band measured on the CPU and pinned (Flax rounds each conv and batch-norm
output to bf16 as the port does; the two differ in where a sum of bf16
products is rounded).

Also here: the ``SAME`` padding rule against ``jax.lax`` (trap 1: on an
even input a stride-2 window pads (0, 1) or (2, 3), where torch pads
symmetrically), the space-to-depth stem's equivalence to the 7x7/s2
stem, the converters' round trip, and the parameter counts of ResNet-50,
VGG-16 and Inception V3 against the reference's trees from
``jax.eval_shape`` (no compile).
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import inception as jax_inception
from horovod_tpu.models import mlp as jax_mlp
from horovod_tpu.models import resnet as jax_resnet
from horovod_tpu.models import vgg as jax_vgg
from horovod_tpu_torch import models
from horovod_tpu_torch.models import _flax_ops, resnet

LOGITS_TOL = 1e-4
GRAD_REL = 1e-4
STATS_TOL = 1e-5
SGD_REL = 1e-5


def _variables(model, shape, seed, **kw):
    """A Flax variable tree for ``model`` on inputs of ``shape``, drawn
    with numpy from ``seed`` (its structure from ``jax.eval_shape``, no
    compile): kernels normal over sqrt(fan in), batch-norm scales and
    biases around 1 and 0 (so that no block is a pass-through), running
    means around 0 and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.ones(shape, jnp.float32), **kw))

    def draw(path, leaf):
        k, shape = path[-1].key, leaf.shape
        if k == "kernel":
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif k == "var":
            x = rng.uniform(0.5, 1.5, shape)
        elif k == "scale":
            x = rng.normal(1.0, 0.2, shape)
        else:  # bias, mean
            x = rng.normal(0.0, 0.1, shape)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, dict(tree))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = np.asarray(v, dtype=np.float32)
    return out


def _port_grads(module):
    """{dotted Flax name: gradient in Flax's layout}."""
    return {name: _flax_ops._to_flax_layout(p.grad).numpy()
            for name, p in module.named_parameters()}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _xent(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, labels).mean()


# -- padding and the stem (trap 1) -------------------------------------------


@pytest.mark.parametrize("size", [7, 8, 31, 32, 224])
@pytest.mark.parametrize("kernel", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_pads_match_jax(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert _flax_ops.same_pads(size, kernel, stride) == tuple(want[0])


@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("kernel,stride", [(1, 2), (3, 1), (3, 2), (7, 2)])
def test_same_conv_and_max_pool_match_jax(size, kernel, stride):
    """A SAME conv and a SAME max-pool on even and odd inputs; the conv
    also at bf16, where Flax rounds the output once as the port does."""
    rng = np.random.default_rng(size * 10 + kernel)
    x = rng.standard_normal((2, size, size, 5), dtype=np.float32)
    w = rng.standard_normal((kernel, kernel, 5, 4), dtype=np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = _flax_ops.Conv(5, 4, kernel, stride, dtype=torch.float32)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        got = conv(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    pooled = flax_nn.max_pool(x, (kernel, kernel), (stride, stride), "SAME")
    got = _flax_ops.max_pool(_nchw(x), kernel, stride, "SAME")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(pooled))


def test_avg_pool_same_excludes_padding_like_flax():
    x = np.random.default_rng(0).standard_normal((2, 9, 9, 3),
                                                 dtype=np.float32)
    want = flax_nn.avg_pool(x, (3, 3), (1, 1), "SAME",
                            count_include_pad=False)
    got = _flax_ops.avg_pool_same(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_s2d_stem_computes_the_7x7_stem():
    """The port's space-to-depth stem (pad (2, 4), 2x2 blocks in (dh, dw,
    c) order, the 7x7 kernel zero-padded to 8x8 and rearranged, a 4x4
    VALID conv) equals the 7x7/s2 SAME conv, as
    tests/test_models.py::test_resnet_s2d_stem_equivalence shows for the
    reference; and its block order is the reference's."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 64, 64, generator=g)
    w7 = torch.randn(16, 3, 7, 7, generator=g) * 0.1
    ref = F.conv2d(_flax_ops.same_pad(x, 7, 2), w7, stride=2)
    xs = resnet.space_to_depth(F.pad(x, (2, 4, 2, 4)), 2)
    got = F.conv2d(xs, resnet.s2d_kernel(w7))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    nhwc = x.permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax_resnet.space_to_depth(jnp.asarray(nhwc), 2))
    np.testing.assert_array_equal(
        resnet.space_to_depth(x, 2).permute(0, 2, 3, 1).numpy(), want)


# -- MLP ---------------------------------------------------------------------


def _train_logits_and_grads(ref, variables, x, labels, **kw):
    """Flax's train-mode logits, gradients and updated batch stats on
    ``x``, jitted (f32: a jitted program computes the eager one's
    function, in XLA's order)."""
    @jax.jit
    def run(variables):
        def loss_fn(params):
            logits, mutated = ref.apply({**variables, "params": params}, x,
                                        mutable=["batch_stats"], **kw)
            return _xent(logits, labels), (logits, mutated)
        (_, (logits, mutated)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        return logits, grads, mutated.get("batch_stats")
    return run(variables)


def _hold_grads(port, grads):
    got = _port_grads(port)
    want = _flat(grads)
    assert got.keys() == want.keys()
    worst = max(_rel_l2(got[k], w) for k, w in want.items())
    assert worst <= GRAD_REL, worst
    return worst


def test_mlp_matches_flax():
    ref = jax_mlp.MnistMLP()
    x = np.random.default_rng(1).standard_normal((4, 28, 28, 1),
                                                 dtype=np.float32)
    labels = np.array([1, 7, 3, 0])
    variables = _variables(ref, x.shape, seed=2)
    want, grads, _ = _train_logits_and_grads(ref, variables, x, labels)
    port = models.MnistMLP(device="cpu")
    _flax_ops.params_from_jax(port, variables)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)  # 6e-7
    F.cross_entropy(got, torch.from_numpy(labels)).backward()
    _hold_grads(port, grads)                                   # 4e-7


# -- ResNet ------------------------------------------------------------------


def _small_resnet(s2d, dtype=jnp.float32):
    ref = jax_resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8,
                            num_classes=10, dtype=dtype,
                            space_to_depth=s2d)
    variables = _variables(ref, (1, 32, 32, 3), seed=5, train=True)
    port = models.ResNet((1, 1, 1, 1), num_classes=10, width=8,
                         dtype=torch.float32 if dtype == jnp.float32
                         else torch.bfloat16, space_to_depth=s2d,
                         device="cpu")
    _flax_ops.params_from_jax(port, variables)
    return ref, variables, port


def _images(n, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3), dtype=np.float32),
            rng.integers(0, 10, n))


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d-stem", "7x7-stem"])
def test_resnet_eval_logits_match_flax(s2d):
    ref, variables, port = _small_resnet(s2d)
    x, _ = _images(3)
    want = jax.jit(lambda v: ref.apply(v, x, train=False))(variables)
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)  # 1.1e-6


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d-stem", "7x7-stem"])
def test_resnet_train_step_matches_flax(s2d):
    """Train mode on 16 images: logits, the running statistics after the
    step (Flax's rule: ra = 0.9 ra + 0.1 batch, with the biased batch
    variance), and every gradient.

    The gradients are held to the reference run in f64
    (``jax.enable_x64``; its classifier head stays f32, as the module
    pins it): with the literal stem the reference's own f32 gradient of
    ``bn_init.bias`` lies 3.7e-3 (relative L2) from its f64 one, a sum of
    4096 terms that nearly cancel, taken in XLA's order. The port's f32
    gradients lie within 1.1e-5 of the f64 reference, and the reference's
    f64 and the port's f64-convolution gradients within 5e-6 of each
    other."""
    ref, variables, port = _small_resnet(s2d)
    x, labels = _images(16)
    want, _, stats = _train_logits_and_grads(ref, variables, x, labels,
                                             train=True)
    with jax.enable_x64(True):
        ref64 = jax_resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8,
                                  num_classes=10, dtype=jnp.float64,
                                  space_to_depth=s2d)
        _, grads, _ = _train_logits_and_grads(
            ref64, jax.tree.map(lambda a: a.astype(np.float64), variables),
            x.astype(np.float64), labels, train=True)
        grads = jax.tree.map(np.asarray, grads)
    port.train()
    got = port(_nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)  # 3.2e-5
    got_stats = _flat(_flax_ops.params_to_numpy(port)["batch_stats"])
    for name, w in _flat(stats).items():
        np.testing.assert_allclose(got_stats[name], w, rtol=0,
                                   atol=STATS_TOL, err_msg=name)  # 1.4e-6
    F.cross_entropy(got, torch.from_numpy(labels)).backward()
    _hold_grads(port, grads)                                 # <= 1.1e-5


def test_resnet_three_sgd_steps_match_flax():
    ref, variables, port = _small_resnet(True)
    x, labels = _images(16, seed=3)
    tx = optax.sgd(0.01)

    @jax.jit
    def step(params, stats, opt_state):
        def loss_fn(p):
            logits, mutated = ref.apply({"params": p, "batch_stats": stats},
                                        x, train=True,
                                        mutable=["batch_stats"])
            return _xent(logits, labels), mutated["batch_stats"]
        (_, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    opt = torch.optim.SGD(port.parameters(), lr=0.01)
    port.train()
    for _ in range(3):
        params, stats, opt_state = step(params, stats, opt_state)
        opt.zero_grad()
        F.cross_entropy(port(_nchw(x)), torch.from_numpy(labels)).backward()
        opt.step()
    got = _flat(_flax_ops.params_to_numpy(port))
    want = _flat({"params": params, "batch_stats": stats})
    assert got.keys() == want.keys()
    worst = max(_rel_l2(got[k], w) for k, w in want.items())
    assert worst <= SGD_REL, worst                             # 1.7e-6


# The bf16 ResNet in eval mode against the jitted Flax module on the 4
# images below: worst |logit| difference 0.0326 on the CPU (logits of
# magnitude ~3); the band is twice that. The f32 module is the yardstick
# of both bf16 ones: the port may be no farther from it than
# BF16_YARDSTICK times the reference is (0.0257 against 0.0209, 1.23).
# (In train mode the last stage's batch norms see 4 values each and
# amplify every rounding: both bf16 modules then lie ~0.1-0.3 from the
# f32 one.)
BF16_LOGITS_ATOL = 2 * 0.0326
BF16_YARDSTICK = 1.5


def test_resnet_bf16_logits_stay_in_the_measured_band():
    ref, variables, port = _small_resnet(True, jnp.bfloat16)
    ref32, _, _ = _small_resnet(True)
    x, _ = _images(4, seed=4)
    want = np.asarray(jax.jit(lambda v: ref.apply(v, x, train=False))(
        variables))
    exact = np.asarray(jax.jit(lambda v: ref32.apply(v, x, train=False))(
        variables))
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    assert got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= BF16_LOGITS_ATOL, err
    ratio = np.abs(got - exact).max() / np.abs(want - exact).max()
    assert ratio <= BF16_YARDSTICK, ratio


# -- VGG and Inception ---------------------------------------------------------


def test_vgg_matches_flax_flatten_order():
    """Three stages at 32x32, dropout 0, f32: the first 4096-wide layer
    reads the (H, W, C) flatten of the reference (trap 2), so logits and
    gradients agree only if the port flattens in that order."""
    stages = ((8, 1), (16, 1), (16, 2))
    ref = jax_vgg.VGG(stages=stages, num_classes=10, dtype=jnp.float32,
                      dropout_rate=0.0)
    x, labels = _images(2, seed=6)
    variables = _variables(ref, x.shape, seed=7, train=False)
    want, grads, _ = _train_logits_and_grads(ref, variables, x, labels,
                                             train=True)
    port = models.VGG(stages, num_classes=10, dtype=torch.float32,
                      dropout_rate=0.0, image_size=32, device="cpu")
    _flax_ops.params_from_jax(port, variables)
    port.train()
    got = port(_nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    F.cross_entropy(got, torch.from_numpy(labels)).backward()
    _hold_grads(port, grads)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_inception_conv_bn_unit_matches_flax(train):
    ref = jax_inception.ConvBN(24, (1, 7), dtype=jnp.float32, train=train)
    x = np.random.default_rng(8).standard_normal((2, 9, 11, 6),
                                                 dtype=np.float32)
    variables = _variables(ref, x.shape, seed=9)
    want, stats = ref.apply(variables, x, mutable=["batch_stats"])
    port = models.inception.ConvBN(6, 24, (1, 7), dtype=torch.float32)
    _flax_ops.params_from_jax(port, variables)
    port.train(train)
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    got_stats = _flat(_flax_ops.params_to_numpy(port)["batch_stats"])
    for name, w in _flat(stats["batch_stats"]).items():
        np.testing.assert_allclose(got_stats[name], w, rtol=0,
                                   atol=STATS_TOL, err_msg=name)


# The whole Inception V3 in train mode: its last blocks run at 1x1, so
# each of their batch norms normalises 8 values, and 94 of them in a row
# amplify every f32 rounding. The reference's own f32 logits lie 2.2e-3
# from its f64 ones there; the port's lie 2.7e-4 from the f64 ones on
# the CPU. So train mode is held to the f64 reference at twice 5e-4,
# and eval mode to the f32 reference at LOGITS_TOL.
INCEPTION_TRAIN_ATOL = 1e-3


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_inception_v3_matches_flax_at_75(train):
    """The whole net at 75x75 on 8 images, dropout 0, f32: every block
    kind (A, the two grid reductions, B, C) and the units' names, which
    Flax gives in construction order, not data-flow order (trap 3):
    ConvBN_8 is the outer 96->96 3x3 of the first A block's double-3x3
    branch, ConvBN_10 its innermost 1x1."""
    x = np.random.default_rng(10).standard_normal((8, 75, 75, 3),
                                                  dtype=np.float32)
    variables = _variables(jax_inception.InceptionV3(num_classes=10),
                           (1, 75, 75, 3), seed=11, train=False)
    with jax.enable_x64(train):
        dtype = jnp.float64 if train else jnp.float32
        ref = jax_inception.InceptionV3(num_classes=10, dtype=dtype,
                                        dropout_rate=0.0)
        want, _ = jax.jit(lambda v: ref.apply(v, x.astype(dtype),
                                              train=train,
                                              mutable=["batch_stats"]))(
            jax.tree.map(lambda a: a.astype(dtype), variables))
        want = np.asarray(want)
    port = models.InceptionV3(num_classes=10, dtype=torch.float32,
                              dropout_rate=0.0, device="cpu")
    _flax_ops.params_from_jax(port, variables)
    assert tuple(port.ConvBN_8.Conv_0.kernel.shape) == (96, 96, 3, 3)
    assert tuple(port.ConvBN_10.Conv_0.kernel.shape) == (64, 192, 1, 1)
    port.train(train)
    with torch.no_grad():
        got = port(_nchw(x))
    tol = INCEPTION_TRAIN_ATOL if train else LOGITS_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


# -- converters and parameter counts -------------------------------------------


def test_converter_round_trips_and_refuses_a_foreign_tree():
    _, variables, port = _small_resnet(False)
    back = _flax_ops.params_to_numpy(port)
    flat_in, flat_back = _flat(variables), _flat(back)
    assert flat_in.keys() == flat_back.keys()
    for k in flat_in:
        np.testing.assert_array_equal(flat_back[k], flat_in[k])
    s2d = models.ResNet((1, 1, 1, 1), num_classes=10, width=8,
                        dtype=torch.float32, device="cpu")
    with pytest.raises(KeyError):
        _flax_ops.params_from_jax(s2d, variables)  # conv_init, not _s2d
    with pytest.raises(ValueError):
        s2d(torch.zeros(1, 3, 31, 31))  # the s2d stem needs even sizes


def _reference_count(model, shape, **kw):
    variables = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.ones(shape), **kw))
    return int(sum(np.prod(x.shape)
                   for x in jax.tree.leaves(variables["params"])))


@pytest.mark.parametrize("name", ["ResNet50", "VGG16", "InceptionV3"])
def test_parameter_counts_match_the_reference(name):
    ref, port, shape = {
        "ResNet50": (jax_resnet.ResNet50(), models.ResNet50,
                     (1, 224, 224, 3)),
        "VGG16": (jax_vgg.VGG16(), models.VGG16, (1, 224, 224, 3)),
        "InceptionV3": (jax_inception.InceptionV3(), models.InceptionV3,
                        (1, 299, 299, 3)),
    }[name]
    n = sum(p.numel() for p in port(device="cpu").parameters())
    assert n == _reference_count(ref, shape, train=False)
    assert n == {"ResNet50": 25_559_912, "VGG16": 138_357_544,
                 "InceptionV3": 23_834_568}[name]
