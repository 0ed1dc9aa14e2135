"""The port's TensorFlow and Keras bindings
(horovod_tpu_torch/tensorflow/, tensorflow/keras/, keras/) against the
JAX package's (horovod_tpu/tensorflow/, keras/).

Spec: tests/test_tensorflow_binding.py, function for function. That
file runs the reference over its 8 in-process ranks; here both packages
run one rank in this process, the port over its eager engine
(``init(device="cpu")``), the reference with ``init(num_ranks=1)``, and
where both compute a value the same seeded inputs go through both:
integer data and sums are compared exactly, fp16 compression within the
reference's rtol 1e-2. Two gloo ranks (tests/torch_ranks.py,
tests/torch_binding_workers.py) check the averages of distinct data.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import horovod_tpu as jhvd  # noqa: E402
import horovod_tpu.tensorflow as jtf  # noqa: E402
import horovod_tpu_torch as thvd  # noqa: E402
import horovod_tpu_torch.tensorflow as hvd  # noqa: E402
import torch_binding_workers as workers  # noqa: E402
from torch_ranks import REPO, spawn_ranks  # noqa: E402

RNG = np.random.default_rng(21)


@pytest.fixture
def tfhvd():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture
def both(tfhvd):
    """The port's binding and the reference's, one rank each."""
    jhvd.shutdown()
    jhvd.init(num_ranks=1)
    yield tfhvd, jtf
    jhvd.shutdown()
    jhvd.init()


def test_tf_allreduce(both):
    x = RNG.integers(-9, 10, (2, 3)).astype(np.float32)
    outs = [m.allreduce(tf.constant(x), name="tf.ar") for m in both]
    for out in outs:
        assert out.dtype == tf.float32
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    np.testing.assert_array_equal(outs[0].numpy(), x)


def test_tf_allreduce_fp16_compression(both):
    x = RNG.standard_normal(8).astype(np.float32)
    outs = [m.allreduce(tf.constant(x), name="tf.fp16",
                        compression=m.Compression.fp16) for m in both]
    for out in outs:
        assert out.dtype == tf.float32
        np.testing.assert_allclose(out.numpy(), x, rtol=1e-2)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-2)


def test_tf_allreduce_indexed_slices(both):
    """Sparse gradients reduce through two allgathers (upstream:
    tensorflow/__init__.py:36-82): values and indices gathered, values
    divided by the size."""
    vals = RNG.integers(-4, 5, (2, 4)).astype(np.float32)
    outs = []
    for m in both:
        slices = tf.IndexedSlices(values=tf.constant(vals),
                                  indices=tf.constant([1, 3]),
                                  dense_shape=tf.constant([8, 4]))
        out = m.allreduce(slices, name="tf.sparse")
        assert isinstance(out, tf.IndexedSlices)
        assert out.values.shape[0] == 2 * m.size()
        outs.append(out)
    np.testing.assert_array_equal(outs[0].values.numpy(),
                                  outs[1].values.numpy())
    np.testing.assert_array_equal(outs[0].indices.numpy(),
                                  outs[1].indices.numpy())


def test_tf_broadcast_variables(tfhvd):
    v1 = tf.Variable([1.0, 2.0])
    v2 = tf.Variable([[3.0]])
    hvd.broadcast_variables([v1, v2], root_rank=0)
    np.testing.assert_array_equal(v1.numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(v2.numpy(), [[3.0]])


def test_tf_distributed_gradient_tape(tfhvd):
    x = tf.Variable(3.0)
    with hvd.DistributedGradientTape() as tape:
        y = x * x
    (g,) = tape.gradient(y, [x])
    assert float(g) == 6.0


def _train(m, steps=5):
    w0 = np.random.default_rng(4).standard_normal((4, 2)).astype(np.float32)
    rng = np.random.default_rng(5)
    x = tf.constant(rng.standard_normal((16, 4)).astype(np.float32))
    y = tf.constant(rng.standard_normal((16, 2)).astype(np.float32))
    w = tf.Variable(w0)
    opt = m.DistributedOptimizer(tf.keras.optimizers.SGD(0.1))
    losses = []
    for _ in range(steps):
        with tf.GradientTape() as tape:
            loss = tf.reduce_mean((x @ w - y) ** 2)
        grads = tape.gradient(loss, [w])
        opt.apply_gradients(zip(grads, [w]))
        losses.append(float(loss))
    return w.numpy(), losses


def test_tf_distributed_optimizer(both):
    """Five SGD steps through the wrapped optimizer: the loss falls, and
    the port's weights are the reference's (one rank: the average is
    the gradient itself)."""
    (w, losses), (jw, jlosses) = (_train(m) for m in both)
    assert losses[-1] < losses[0]
    np.testing.assert_array_equal(w, jw)
    assert losses == jlosses


def test_keras_surface_imports(tfhvd):
    import horovod_tpu_torch.keras as hk
    import horovod_tpu_torch.tensorflow.keras as htk
    assert hk.DistributedOptimizer is htk.DistributedOptimizer
    assert hk.load_model is htk.load_model
    assert hk.size() == 1


def test_mxnet_gated():
    """Without mxnet importable the binding raises, not half-works."""
    import importlib.util
    if importlib.util.find_spec("mxnet") is not None:
        pytest.skip("mxnet installed: the gate does not apply")
    sys.modules.pop("horovod_tpu_torch.mxnet", None)
    with pytest.raises(ImportError, match="mxnet"):
        import horovod_tpu_torch.mxnet  # noqa: F401


def test_tf_allreduce_grad(both):
    """The gradient of an allreduce is the allreduce of the gradient
    (upstream: test_horovod_allreduce_grad): size for a sum, 1 for an
    average; the reference's gradients equal the port's."""
    for average in (False, True):
        grads = []
        for m in both:
            x = tf.Variable([[1.0, 2.0], [3.0, 4.0]])
            with tf.GradientTape() as tape:
                y = m.allreduce(x, average=average,
                                name=f"tf.grad.{average}")
                loss = tf.reduce_sum(y)
            grads.append(tape.gradient(loss, x).numpy())
        np.testing.assert_array_equal(grads[0], grads[1])
        np.testing.assert_array_equal(
            grads[0], np.full((2, 2), 1.0 if average else hvd.size()))


def test_tf_allreduce_dtype_matrix(both):
    """Per-dtype sums (upstream: test_tensorflow.py:84-115), the port's
    equal to the reference's, in the input's dtype."""
    for dtype in (tf.uint8, tf.int8, tf.int32, tf.int64, tf.float16,
                  tf.float32, tf.float64):
        t = tf.cast(tf.constant(RNG.integers(0, 9, (2, 3))), dtype)
        outs = [m.allreduce(t, average=False, name=f"tf.mx.{dtype.name}")
                for m in both]
        for out in outs:
            assert out.dtype == dtype, (dtype, out.dtype)
        np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
        np.testing.assert_array_equal(outs[0].numpy(),
                                      t.numpy() * hvd.size())


def test_tf_function_training(tfhvd):
    """Training under tf.function: the py_function hop carries the
    allreduce inside a traced step."""
    w = tf.Variable([2.0, -1.0])
    opt = tf.keras.optimizers.SGD(0.1)

    @tf.function
    def step(x, y):
        with tf.GradientTape() as tape:
            pred = tf.reduce_sum(w * x, axis=-1)
            loss = tf.reduce_mean((pred - y) ** 2)
        grads = tape.gradient(loss, [w])
        grads = [hvd.allreduce(g, average=True, name=f"tff.{i}")
                 for i, g in enumerate(grads)]
        opt.apply_gradients(zip(grads, [w]))
        return loss

    x = tf.constant([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    y = tf.constant([1.0, 1.0, 2.0])
    losses = [float(step(x, y)) for _ in range(20)]
    assert losses[-1] < losses[0] * 0.2, losses


def test_tf_distributed_gradient_tape_ownership(tfhvd):
    """Wrapping a tape transfers ownership: gradient() on the wrapper
    works, on the donor raises instead of releasing the tape twice."""
    x = tf.Variable(3.0)
    with tf.GradientTape() as inner:
        y = x * x
    wrapped = hvd.DistributedGradientTape(inner)
    (g,) = wrapped.gradient(y, [x])
    assert float(g) == 6.0
    with pytest.raises(Exception):
        inner.gradient(y, [x])


def _fit_and_save(path, opt, activation=None, in_dim=4, out_dim=3):
    model = tf.keras.Sequential(
        [tf.keras.layers.Dense(out_dim, input_shape=(in_dim,),
                               activation=activation)])
    model.compile(optimizer=opt, loss="mse")
    model.fit(np.ones((8, in_dim), np.float32),
              np.zeros((8, out_dim), np.float32), epochs=1, verbose=0)
    model.save(path)


def test_keras_load_model_rewraps_optimizer(tfhvd, tmp_path):
    """A model saved with a DistributedOptimizer comes back through
    hvd.load_model with a Distributed-wrapped optimizer (upstream:
    _keras/__init__.py:93-109) that trains through the allreduce."""
    import horovod_tpu_torch.keras as khvd
    path = str(tmp_path / "m.keras")
    _fit_and_save(path, hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.1)))
    restored = khvd.load_model(path)
    assert type(restored.optimizer).__name__.startswith("Distributed")
    restored.fit(np.ones((8, 4), np.float32), np.zeros((8, 3), np.float32),
                 epochs=1, verbose=0)


def test_broadcast_global_variables_graph_mode(tfhvd):
    """compat.v1 graphs: the collection is populated and the returned op
    broadcasts (upstream: tensorflow/__init__.py:85-92)."""
    g = tf.Graph()
    with g.as_default():
        v = tf.compat.v1.get_variable(
            "bgv_v", initializer=np.arange(4, dtype=np.float32))
        op = hvd.broadcast_global_variables(0)
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            sess.run(op)
            np.testing.assert_array_equal(sess.run(v), np.arange(4))


def test_broadcast_global_variables_hook(tfhvd):
    g = tf.Graph()
    with g.as_default():
        v = tf.compat.v1.get_variable(
            "bgvh_v", initializer=np.full((3,), 7.0, np.float32))
        hook = hvd.BroadcastGlobalVariablesHook(0)
        hook.begin()
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            hook.after_create_session(sess, None)
            np.testing.assert_array_equal(sess.run(v), np.full((3,), 7.0))


def test_broadcast_global_variables_eager_raises(tfhvd):
    with pytest.raises(NotImplementedError, match="broadcast_variables"):
        hvd.broadcast_global_variables(0)


def test_tf_allgather_grad(both):
    """The gradient of an allgather is this rank's slice of the summed
    gradient (upstream: test_horovod_allgather_grad)."""
    grads = []
    for m in both:
        x = tf.Variable(tf.ones([2, 3]))
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(m.allgather(x, name="tf.ag.grad") * 3.0)
        grads.append(tape.gradient(loss, x).numpy())
    np.testing.assert_array_equal(grads[0], grads[1])
    np.testing.assert_array_equal(grads[0],
                                  np.full((2, 3), 3.0 * hvd.size()))


def test_tf_broadcast_grad(both):
    """The gradient of a broadcast: summed to the root, zero elsewhere
    (upstream: test_horovod_broadcast_grad)."""
    grads = []
    for m in both:
        x = tf.Variable(tf.ones([4]))
        with tf.GradientTape() as tape:
            b = m.broadcast(x, root_rank=0, name="tf.bc.grad")
            loss = tf.reduce_sum(b * 2.0)
        grads.append(tape.gradient(loss, x).numpy())
    np.testing.assert_array_equal(grads[0], grads[1])
    np.testing.assert_array_equal(grads[0], np.full((4,), 2.0 * hvd.size()))


def test_tf_allgather_grad_indexed_slices(tfhvd):
    """tf.gather hands IndexedSlices back through the allgather's
    gradient, which densifies them."""
    x = tf.Variable(tf.ones([4, 3]))
    with tf.GradientTape() as tape:
        g = hvd.allgather(x, name="tf.ag.is")
        loss = tf.reduce_sum(tf.gather(g, [0, 2]))
    grad = tf.convert_to_tensor(tape.gradient(loss, x))
    assert tuple(grad.shape) == (4, 3)
    np.testing.assert_array_equal(grad.numpy()[[0, 2]], np.ones((2, 3)))


def test_tf_broadcast_grad_indexed_slices(tfhvd):
    x = tf.Variable(tf.ones([4, 3]))
    with tf.GradientTape() as tape:
        b = hvd.broadcast(x, root_rank=0, name="tf.bc.is")
        loss = tf.reduce_sum(tf.gather(b, [1, 3]))
    grad = tf.convert_to_tensor(tape.gradient(loss, x))
    np.testing.assert_array_equal(grad.numpy()[[1, 3]], np.ones((2, 3)))


def test_keras_load_model_custom_optimizer(tfhvd, tmp_path):
    """custom_optimizers re-map by class name on restore (upstream:
    test_keras.py::test_load_model_custom_optimizers)."""
    import horovod_tpu_torch.keras as khvd

    class MySGD(tf.keras.optimizers.SGD):
        pass

    path = str(tmp_path / "c.keras")
    _fit_and_save(path, hvd.DistributedOptimizer(MySGD(0.05)), in_dim=3,
                  out_dim=2)
    restored = khvd.load_model(path, custom_optimizers=[MySGD])
    assert type(restored.optimizer).__name__ == "DistributedMySGD"


def test_keras_load_model_grandchild_optimizer(tfhvd, tmp_path):
    """A user optimizer two classes below Optimizer is re-mapped without
    custom_optimizers, and a wrapper is never wrapped again."""
    import horovod_tpu_torch.keras as khvd

    class MyAdamChild(tf.keras.optimizers.Adam):
        pass

    path = str(tmp_path / "g.keras")
    _fit_and_save(path, hvd.DistributedOptimizer(MyAdamChild(0.01)),
                  in_dim=3, out_dim=2)
    restored = khvd.load_model(path)
    assert type(restored.optimizer).__name__ == "DistributedMyAdamChild"


def test_keras_load_model_custom_objects(tfhvd, tmp_path):
    """custom_objects pass through untouched (upstream:
    test_keras.py::test_load_model_custom_objects)."""
    import horovod_tpu_torch.keras as khvd

    @tf.keras.utils.register_keras_serializable("hvdtorchtest")
    def my_act(x):
        return tf.nn.relu(x) * 2.0

    path = str(tmp_path / "o.keras")
    _fit_and_save(path, hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.05)), activation=my_act, in_dim=3,
        out_dim=2)
    restored = khvd.load_model(path, custom_objects={"my_act": my_act})
    assert type(restored.optimizer).__name__.startswith("Distributed")
    restored.predict(np.ones((2, 3), np.float32), verbose=0)


def test_two_ranks_average_what_each_holds():
    """Two gloo ranks, each with its own seeded values: the dense
    average, the IndexedSlices path, DistributedGradientTape's
    gradients, a DistributedOptimizer step, the keras callbacks'
    broadcast and metric average, against numpy."""
    rng = np.random.default_rng(8)
    inp = {"x": [rng.integers(-9, 10, (3, 2)).astype(np.float32)
                 for _ in range(2)],
           "w": [rng.standard_normal(3).astype(np.float32)
                 for _ in range(2)],
           "metric": [1.5, 4.0]}
    out = spawn_ranks(2, workers.tensorflow_ranks, inp, timeout=180)
    total = inp["x"][0] + inp["x"][1]
    for r in out:
        np.testing.assert_array_equal(r["mean"], total / 2)
        np.testing.assert_array_equal(r["sum"], total)
        np.testing.assert_array_equal(r["slices_values"],
                                      np.concatenate(inp["x"]) / 2)
        np.testing.assert_array_equal(r["slices_indices"], [0, 2, 0, 2])
        # d/dw sum(w * x_r) is x_r, averaged over the ranks
        np.testing.assert_array_equal(r["tape"], total / 2)
        np.testing.assert_allclose(
            r["opt_w"], inp["w"][0] - np.float32(0.1)
            * ((inp["w"][0] + inp["w"][1]) / 2), rtol=1e-6)
        np.testing.assert_array_equal(r["bcast"], inp["w"][0])
        assert r["metric"] == 2.75
    np.testing.assert_array_equal(out[0]["opt_w"], out[1]["opt_w"])


def test_importing_the_port_imports_no_tensorflow():
    """``import horovod_tpu_torch`` leaves TensorFlow unimported (the
    machine with the card has none); only the binding imports it."""
    code = ("import sys, horovod_tpu_torch\n"
            "assert 'tensorflow' not in sys.modules\n"
            "assert 'keras' not in sys.modules\n"
            "import horovod_tpu_torch.spark\n"
            "assert 'tensorflow' not in sys.modules\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
