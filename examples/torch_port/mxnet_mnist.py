"""MXNet MNIST training on horovod_tpu_torch's MXNet binding.

Counterpart of examples/mxnet_mnist.py: a gluon conv net, per-rank MNIST
shards, ``DistributedTrainer``, ``broadcast_parameters`` from rank 0 and a
metric allreduce at each epoch's end, over ``horovod_tpu_torch.mxnet``,
whose NDArrays cross to the port's eager engine on the host. Synthetic
MNIST-shaped data (nothing is downloaded). MXNet is retired and is
installed neither here nor on the machine with the card, so ``--shim``
loads tests/mxnet_mock.py and trains a linear softmax classifier with
hand-written gradients through the same ``horovod_tpu_torch.mxnet``
calls (``broadcast_parameters``, ``DistributedTrainer``, ``allreduce``).
The engine runs on the card by default, on the CPU with ``--device
cpu``. Prints ``DONE``, then a JSON summary (the epoch losses, the
engine's device and the process group's backend) as its last line.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

parser = argparse.ArgumentParser(description="MXNet MNIST Example")
parser.add_argument("--batch-size", type=int, default=64)
parser.add_argument("--epochs", type=int, default=2)
parser.add_argument("--steps-per-epoch", type=int, default=8)
parser.add_argument("--lr", type=float, default=0.05)
parser.add_argument("--shim", action="store_true",
                    help="use tests/mxnet_mock.py instead of real mxnet "
                         "(where mxnet is not installed)")
parser.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (default) or cpu")
args = parser.parse_args()

if args.shim:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                    "tests"))
    import mxnet_mock
    sys.modules["mxnet"] = mxnet_mock

import mxnet as mx  # noqa: E402
import horovod_tpu_torch.mxnet as hvd  # noqa: E402
from horovod_tpu_torch import runtime  # noqa: E402

hvd.init(device=args.device)
np.random.seed(1234 + hvd.rank())


def synthetic_mnist(n):
    """Linearly-separable MNIST-shaped data so loss provably falls."""
    x = np.random.randn(n, 784).astype(np.float32)
    w_true = np.random.RandomState(0).randn(784, 10).astype(np.float32)
    y = (x @ w_true).argmax(axis=1).astype(np.int64)
    return x, y


def softmax_xent_grad(logits, labels):
    """Returns (mean loss, dlogits)."""
    z = logits - logits.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    n = len(labels)
    loss = -np.log(p[np.arange(n), labels] + 1e-9).mean()
    d = p
    d[np.arange(n), labels] -= 1.0
    return loss, d / n


def train_shim():
    """Linear classifier, hand-written gradient, full hvd.mxnet surface.
    Returns the epochs' rank-averaged last losses."""
    x, y = synthetic_mnist(args.batch_size * args.steps_per_epoch)
    w = mx.nd.array(np.zeros((784, 10), np.float32))
    b = mx.nd.array(np.zeros((10,), np.float32))
    params = [mx.gluon.parameter.Parameter("w", data=w.asnumpy(),
                                           grad=np.zeros((784, 10),
                                                         np.float32)),
              mx.gluon.parameter.Parameter("b", data=b.asnumpy(),
                                           grad=np.zeros(10, np.float32))]
    hvd.broadcast_parameters({p.name: p.data() for p in params})
    opt = mx.optimizer.Optimizer(learning_rate=args.lr, rescale_grad=1.0)
    trainer = hvd.DistributedTrainer(params, opt)

    first = last = None
    epoch_losses = []
    for epoch in range(args.epochs):
        for step in range(args.steps_per_epoch):
            s = slice(step * args.batch_size, (step + 1) * args.batch_size)
            xb, yb = x[s], y[s]
            wv = params[0].data().asnumpy()
            bv = params[1].data().asnumpy()
            loss, dlogits = softmax_xent_grad(xb @ wv + bv, yb)
            params[0].list_grad()[0][:] = xb.T @ dlogits
            params[1].list_grad()[0][:] = dlogits.sum(axis=0)
            trainer.step(batch_size=1)
            if first is None:
                first = loss
            last = loss
        avg = hvd.allreduce(mx.nd.array(np.float32([last])),
                            name=f"loss.{epoch}")
        epoch_losses.append(float(avg.asnumpy()[0]))
        print(f"Epoch {epoch}: loss {epoch_losses[-1]:.4f}")
    assert last < first, (first, last)
    print(f"loss {first:.4f} -> {last:.4f}")
    return [float(first)] + epoch_losses


def train_gluon():
    """Real-MXNet path: gluon conv net mirroring the reference example."""
    from mxnet import autograd, gluon

    ctx = mx.cpu()
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(channels=20, kernel_size=5, activation="relu"))
    net.add(gluon.nn.MaxPool2D(pool_size=2, strides=2))
    net.add(gluon.nn.Conv2D(channels=50, kernel_size=5, activation="relu"))
    net.add(gluon.nn.MaxPool2D(pool_size=2, strides=2))
    net.add(gluon.nn.Flatten())
    net.add(gluon.nn.Dense(512, activation="relu"))
    net.add(gluon.nn.Dense(10))
    net.initialize(ctx=ctx)
    net(mx.nd.zeros((1, 1, 28, 28), ctx=ctx))  # materialize shapes

    params = net.collect_params()
    hvd.broadcast_parameters(params)
    trainer = hvd.DistributedTrainer(
        params, "sgd", {"learning_rate": args.lr * hvd.size()})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    x, y = synthetic_mnist(args.batch_size * args.steps_per_epoch)
    x = x.reshape(-1, 1, 28, 28)
    losses = []
    for epoch in range(args.epochs):
        for step in range(args.steps_per_epoch):
            s = slice(step * args.batch_size, (step + 1) * args.batch_size)
            data = mx.nd.array(x[s], ctx=ctx)
            label = mx.nd.array(y[s], ctx=ctx)
            with autograd.record():
                loss = loss_fn(net(data), label)
            loss.backward()
            trainer.step(args.batch_size)
        losses.append(float(loss.mean().asnumpy()))
        print(f"Epoch {epoch}: loss {losses[-1]:.4f}")
    return losses


losses = train_shim() if args.shim else train_gluon()
summary = {"example": "mxnet_mnist", "rank": hvd.rank(), "shim": args.shim,
           "device": args.device, "engine_device": str(runtime.engine().device),
           "backend": torch.distributed.get_backend(), "losses": losses}
hvd.shutdown()
print("DONE")
print(json.dumps(summary), flush=True)
