"""MXNet ResNet-50 ImageNet training on horovod_tpu_torch's MXNet
binding.

Counterpart of examples/mxnet_imagenet_resnet50.py: the recipe's
distributed skeleton (``broadcast_parameters`` -> ``DistributedTrainer``
-> a metric allreduce each epoch, Goyal-style linear warmup scaled by
``hvd.size()``) on synthetic data, over ``horovod_tpu_torch.mxnet``;
real-MXNet users plug their data iterator in. MXNet is installed neither
here nor on the machine with the card, so ``--shim`` drives the same
calls through tests/mxnet_mock.py with a linear classifier and
hand-written gradients. The engine runs on the card by default, on the
CPU with ``--device cpu``. Prints ``DONE``, then a JSON summary as its
last line.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

parser = argparse.ArgumentParser(
    description="MXNet ImageNet ResNet-50 Example")
parser.add_argument("--batch-size", type=int, default=32)
parser.add_argument("--epochs", type=int, default=2)
parser.add_argument("--steps-per-epoch", type=int, default=4)
parser.add_argument("--lr", type=float, default=0.0125,
                    help="per-worker base LR (reference default; scaled "
                         "by hvd.size() with linear warmup)")
parser.add_argument("--warmup-epochs", type=int, default=1)
parser.add_argument("--image-size", type=int, default=64)
parser.add_argument("--num-classes", type=int, default=100)
parser.add_argument("--shim", action="store_true",
                    help="use tests/mxnet_mock.py instead of real mxnet")
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

hvd.init(device=args.device)
np.random.seed(4321 + hvd.rank())


def warmup_lr(epoch, step, steps_per_epoch):
    """Linear warmup from lr to lr*size over warmup_epochs (Goyal et al.;
    reference: examples/mxnet_imagenet_resnet50.py LRSequential blocks)."""
    target = args.lr * hvd.size()
    total_warmup = args.warmup_epochs * steps_per_epoch
    t = epoch * steps_per_epoch + step
    if t >= total_warmup:
        return target
    return args.lr + (target - args.lr) * t / total_warmup


def synthetic_batch(n):
    x = np.random.randn(n, args.image_size * args.image_size
                        ).astype(np.float32)
    w_true = np.random.RandomState(0).randn(
        x.shape[1], args.num_classes).astype(np.float32)
    y = (x @ w_true).argmax(axis=1).astype(np.int64)
    return x, y


def softmax_xent_grad(logits, labels):
    z = logits - logits.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    n = len(labels)
    loss = -np.log(p[np.arange(n), labels] + 1e-9).mean()
    d = p
    d[np.arange(n), labels] -= 1.0
    return loss, d / n


def train_shim():
    dim = args.image_size * args.image_size
    params = [mx.gluon.parameter.Parameter(
        "w", data=np.zeros((dim, args.num_classes), np.float32),
        grad=np.zeros((dim, args.num_classes), np.float32))]
    hvd.broadcast_parameters({p.name: p.data() for p in params})
    opt = mx.optimizer.Optimizer(learning_rate=args.lr, rescale_grad=1.0)
    trainer = hvd.DistributedTrainer(params, opt)

    x, y = synthetic_batch(args.batch_size * args.steps_per_epoch)
    first = last = None
    epoch_losses = []
    for epoch in range(args.epochs):
        for step in range(args.steps_per_epoch):
            s = slice(step * args.batch_size, (step + 1) * args.batch_size)
            xb, yb = x[s], y[s]
            opt.set_learning_rate(warmup_lr(epoch, step,
                                            args.steps_per_epoch))
            wv = params[0].data().asnumpy()
            loss, dlogits = softmax_xent_grad(xb @ wv, yb)
            params[0].list_grad()[0][:] = xb.T @ dlogits
            trainer.step(batch_size=1)
            if first is None:
                first = loss
            last = loss
        avg = hvd.allreduce(mx.nd.array(np.float32([last])),
                            name=f"r50.loss.{epoch}")
        epoch_losses.append(float(avg.asnumpy()[0]))
        print(f"Epoch {epoch}: loss {epoch_losses[-1]:.4f}, "
              f"lr {opt.lr:.5f}")
    assert last < first, (first, last)
    print(f"loss {first:.4f} -> {last:.4f}")
    return [float(first)] + epoch_losses


def train_gluon():
    from mxnet import autograd, gluon
    from mxnet.gluon.model_zoo import vision

    ctx = mx.cpu()
    net = vision.resnet50_v2(classes=args.num_classes)
    net.initialize(ctx=ctx)
    net(mx.nd.zeros((1, 3, args.image_size, args.image_size), ctx=ctx))

    params = net.collect_params()
    hvd.broadcast_parameters(params)
    trainer = hvd.DistributedTrainer(
        params, "sgd", {"learning_rate": args.lr * hvd.size(),
                        "momentum": 0.9, "wd": 1e-4})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    losses = []
    for epoch in range(args.epochs):
        for step in range(args.steps_per_epoch):
            x, y = synthetic_batch(args.batch_size)
            data = mx.nd.array(
                np.repeat(x.reshape(-1, 1, args.image_size,
                                    args.image_size), 3, axis=1), ctx=ctx)
            label = mx.nd.array(y, ctx=ctx)
            with autograd.record():
                loss = loss_fn(net(data), label)
            loss.backward()
            trainer.step(args.batch_size)
        losses.append(float(loss.mean().asnumpy()))
        print(f"Epoch {epoch}: loss {losses[-1]:.4f}")
    return losses


losses = train_shim() if args.shim else train_gluon()
summary = {"example": "mxnet_imagenet_resnet50", "rank": hvd.rank(),
           "shim": args.shim, "device": args.device, "losses": losses}
hvd.shutdown()
print("DONE")
print(json.dumps(summary), flush=True)
