"""The port's MXNet binding (horovod_tpu_torch/mxnet/) over
tests/mxnet_mock.py, against the JAX package's (horovod_tpu/mxnet/).

Spec: tests/test_mxnet_binding.py, function for function. That file
runs the reference over its 8 in-process ranks; here both packages run
one rank in this process (the port's eager engine with
``init(device="cpu")``, the reference with ``init(num_ranks=1)``) on the
same seeded values, compared exactly; two gloo ranks
(tests/torch_binding_workers.py) check the averages of distinct data.
MXNet is installed nowhere: the mock stands in for it.
"""

import importlib
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import mxnet_mock  # noqa: E402

import horovod_tpu as jhvd  # noqa: E402
import torch_binding_workers as workers  # noqa: E402
from torch_ranks import spawn_ranks  # noqa: E402

mx = mxnet_mock
RNG = np.random.default_rng(31)


def _load(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "mxnet", mxnet_mock)
    sys.modules.pop(name, None)
    return importlib.import_module(name)


@pytest.fixture
def mxhvd(monkeypatch):
    mod = _load("horovod_tpu_torch.mxnet", monkeypatch)
    mod.init(device="cpu")
    yield mod
    mod.shutdown()
    sys.modules.pop("horovod_tpu_torch.mxnet", None)


@pytest.fixture
def both(mxhvd, monkeypatch):
    """The port's binding and the reference's, one rank each."""
    ref = _load("horovod_tpu.mxnet", monkeypatch)
    jhvd.shutdown()
    jhvd.init(num_ranks=1)
    yield mxhvd, ref
    jhvd.shutdown()
    jhvd.init()
    sys.modules.pop("horovod_tpu.mxnet", None)


def test_gate_without_mxnet():
    """Without mxnet the module raises the documented ImportError
    (upstream's check_extension, horovod/common/util.py:41)."""
    if importlib.util.find_spec("mxnet") is not None:
        pytest.skip("real mxnet installed: the gate does not apply")
    sys.modules.pop("horovod_tpu_torch.mxnet", None)
    sys.modules.pop("mxnet", None)
    with pytest.raises(ImportError, match="requires the 'mxnet' package"):
        importlib.import_module("horovod_tpu_torch.mxnet")


def test_mx_allreduce(both):
    x = RNG.integers(-9, 10, (4, 3)).astype(np.float32)
    for average in (True, False):
        outs = [m.allreduce(mx.nd.array(x), average=average,
                            name=f"mx.ar.{average}") for m in both]
        for out in outs:
            assert isinstance(out, mx.NDArray) and out.dtype == np.float32
        np.testing.assert_array_equal(outs[0].asnumpy(), outs[1].asnumpy())
        np.testing.assert_array_equal(outs[0].asnumpy(), x)


def test_mx_allreduce_inplace(both):
    x = RNG.integers(-9, 10, (5,)).astype(np.float32)
    outs = []
    for m in both:
        t = mx.nd.array(x)
        out = m.allreduce_(t, average=False, name="mx.ar.in")
        assert out is t
        outs.append(t.asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_mx_allgather(both):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    outs = [m.allgather(mx.nd.array(x), name="mx.ag") for m in both]
    assert outs[0].shape == (2 * both[0].size(), 3)
    np.testing.assert_array_equal(outs[0].asnumpy(), outs[1].asnumpy())


def test_mx_broadcast(mxhvd):
    t = mx.nd.array(np.arange(4, dtype=np.float32))
    out = mxhvd.broadcast(t, root_rank=0, name="mx.bc")
    np.testing.assert_array_equal(out.asnumpy(), t.asnumpy())
    t2 = mx.nd.array(np.ones(3, np.float32))
    assert mxhvd.broadcast_(t2, 0, name="mx.bc.in") is t2


def test_mx_distributed_optimizer_rescale(both):
    """rescale_grad is divided by the size so the summed allreduce
    averages (upstream: horovod/mxnet/__init__.py:41-44); the port's
    step is the reference's."""
    g0 = RNG.standard_normal(3).astype(np.float32)
    ws = []
    for m in both:
        opt = mx.Optimizer(learning_rate=0.5, rescale_grad=1.0)
        dopt = m.DistributedOptimizer(opt)
        assert opt.rescale_grad == 1.0 / m.size()
        assert dopt.lr == 0.5  # delegation through __getattr__
        w = mx.nd.array(np.ones(3, np.float32))
        dopt.update(7, w, mx.nd.array(g0), None)
        assert opt.updates == [7]
        ws.append(w.asnumpy())
    np.testing.assert_array_equal(ws[0], ws[1])
    np.testing.assert_allclose(ws[0], 1.0 - 0.5 * g0, rtol=1e-6)


def test_mx_distributed_optimizer_list_index(mxhvd):
    opt = mx.Optimizer(learning_rate=0.1)
    dopt = mxhvd.DistributedOptimizer(opt)
    w = [mx.nd.array(np.ones(2, np.float32)) for _ in range(2)]
    g = [mx.nd.array(np.full((2,), 0.2, np.float32)) for _ in range(2)]
    dopt.update([3, 4], w, g, None)
    # the index list reaches the wrapped optimizer's update intact
    assert opt.updates == [[3, 4]]
    np.testing.assert_array_equal(g[0].asnumpy(),
                                  np.full((2,), 0.2 * mxhvd.size(),
                                          np.float32))


def test_mx_distributed_trainer(mxhvd):
    params = [mx.Parameter(f"p{i}", data=np.ones(3, np.float32),
                           grad=np.full((3,), 0.4, np.float32))
              for i in range(2)]
    opt = mx.Optimizer(learning_rate=1.0, rescale_grad=1.0)
    trainer = mxhvd.DistributedTrainer(params, opt)
    assert trainer._scale == 1.0 / mxhvd.size()
    trainer.step(batch_size=1)
    for p in params:
        np.testing.assert_allclose(p.data().asnumpy(),
                                   np.full((3,), 1.0 - 0.4), rtol=1e-6)


def test_mx_distributed_trainer_unwraps(mxhvd):
    opt = mx.Optimizer(learning_rate=1.0)
    dopt = mxhvd.DistributedOptimizer(opt)
    with pytest.warns(UserWarning, match="unwrapped"):
        trainer = mxhvd.DistributedTrainer([], dopt)
    assert trainer._optimizer is opt


def test_mx_broadcast_parameters_dict(mxhvd):
    tensors = {f"w{i}": mx.nd.array(np.full((2, 2), float(i), np.float32))
               for i in range(3)}
    mxhvd.broadcast_parameters(tensors)
    for i in range(3):
        np.testing.assert_array_equal(tensors[f"w{i}"].asnumpy(),
                                      np.full((2, 2), float(i)))


def test_mx_broadcast_parameters_deferred(mxhvd):
    """Deferred-init parameters get the broadcast appended to _init_impl
    (upstream: horovod/mxnet/__init__.py:105-113, 131-137)."""
    pd = mx.ParameterDict()
    pd["a"] = mx.Parameter("a", data=np.ones(2, np.float32))
    deferred = mx.Parameter("b")  # no data yet
    pd["b"] = deferred
    mxhvd.broadcast_parameters(pd)
    deferred.initialize(data=np.full((2,), 5.0, np.float32))
    np.testing.assert_array_equal(deferred.data().asnumpy(),
                                  np.full((2,), 5.0))


def test_mx_broadcast_parameters_invalid(mxhvd):
    with pytest.raises(ValueError, match="invalid params of type"):
        mxhvd.broadcast_parameters([1, 2, 3])


def test_two_ranks_average_what_each_holds():
    """Two gloo ranks with their own values: the average and sum, the
    gather, the root's broadcast, and a DistributedTrainer step whose
    gradient is the average of the ranks'."""
    rng = np.random.default_rng(9)
    inp = {"x": [rng.integers(-9, 10, (2, 3)).astype(np.float32)
                 for _ in range(2)],
           "g": [rng.standard_normal(3).astype(np.float32)
                 for _ in range(2)]}
    out = spawn_ranks(2, workers.mxnet_ranks, inp, timeout=120)
    total = inp["x"][0] + inp["x"][1]
    for r in out:
        np.testing.assert_array_equal(r["mean"], total / 2)
        np.testing.assert_array_equal(r["sum"], total)
        np.testing.assert_array_equal(r["gather"], np.concatenate(inp["x"]))
        np.testing.assert_array_equal(r["bcast"], inp["x"][0])
        np.testing.assert_allclose(
            r["trained"], 1.0 - (inp["g"][0] + inp["g"][1]) / 2, rtol=1e-6)
    np.testing.assert_array_equal(out[0]["trained"], out[1]["trained"])
