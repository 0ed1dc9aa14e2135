"""ImageNet-style ResNet-50 training on horovod_tpu_torch — the full
recipe.

Counterpart of examples/pytorch_imagenet_resnet50.py and
examples/jax_imagenet_resnet50.py, with their flags: the dataset sharded
by rank (each rank draws its own), gradient accumulation over
--batches-per-allreduce (``DistributedOptimizer``'s
``backward_passes_per_step``), the reference's learning-rate warm-up and
staircase decay applied per batch, rank-0 checkpointing with resume
(--checkpoint-format), parameters AND optimizer state broadcast at the
start, validation metrics averaged over the ranks.

The model is the port's ResNet-50 (horovod_tpu_torch/models/resnet.py)
at its published width: 224 x 224 input, 1000 classes, bf16 compute with
f32 parameters, channels_last on a card. The data is synthetic and
nothing is downloaded (no torchvision): each rank draws a fixed set of
--steps-per-epoch x --batches-per-allreduce training batches and one
validation batch from a seeded generator, and every epoch passes over
the same set, so the training loss falls. Runs on the card by default,
on the CPU with ``--device cpu`` (a small --image-size keeps that
quick). The last line is a JSON summary of the losses.

Run: python examples/torch_port/pytorch_imagenet_resnet50.py
         [--checkpoint-format DIR/checkpoint-{epoch}.pth] [--device cpu]
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import ResNet50

parser = argparse.ArgumentParser(
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--checkpoint-format",
                    default="torch_port_ckpt/checkpoint-{epoch}.pth")
parser.add_argument("--batch-size", type=int, default=8)
parser.add_argument("--val-batch-size", type=int, default=8)
parser.add_argument("--epochs", type=int, default=2)
parser.add_argument("--steps-per-epoch", type=int, default=3)
parser.add_argument("--base-lr", type=float, default=0.0125)
parser.add_argument("--warmup-epochs", type=float, default=1)
parser.add_argument("--momentum", type=float, default=0.9)
parser.add_argument("--wd", type=float, default=5e-5)
parser.add_argument("--batches-per-allreduce", type=int, default=2,
                    help="accumulate this many local batches per allreduce")
parser.add_argument("--image-size", type=int, default=224,
                    help="square image edge (ResNet pools globally, so "
                         "smaller even sizes work for smoke runs)")
parser.add_argument("--num-classes", type=int, default=1000)
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = parser.parse_args()


def adjust_learning_rate(optimizer, epoch, batch_idx, steps_per_epoch):
    """The reference's math (pytorch_imagenet_resnet50.py): the warm-up
    ramps 1 -> size over warmup_epochs, then a /10 staircase."""
    if epoch < args.warmup_epochs:
        ep = epoch + float(batch_idx + 1) / steps_per_epoch
        lr_adj = (ep / args.warmup_epochs * (hvd.size() - 1) + 1) / hvd.size()
    elif epoch < 0.5 * args.epochs:
        lr_adj = 1.0
    elif epoch < 0.75 * args.epochs:
        lr_adj = 1e-1
    else:
        lr_adj = 1e-2
    for pg in optimizer.param_groups:
        pg["lr"] = args.base_lr * hvd.size() * lr_adj


def metric_average(val, name):
    return float(hvd.allreduce(torch.tensor(val), average=True, name=name))


def synthetic(rng, n, device, memory_format):
    """``n`` images (N, 3, S, S) and their labels on ``device``."""
    s = args.image_size
    x = torch.from_numpy(rng.standard_normal((n, 3, s, s), np.float32))
    y = torch.from_numpy(rng.integers(0, args.num_classes, n))
    return (x.to(device).contiguous(memory_format=memory_format),
            y.to(device))


def main():
    hvd.init(device=args.device)
    device = hvd.runtime.device()
    fmt = (torch.channels_last if device.type == "cuda"
           else torch.contiguous_format)
    model = ResNet50(num_classes=args.num_classes,
                     generator=torch.Generator().manual_seed(42),
                     device=device).to(memory_format=fmt)
    optimizer = torch.optim.SGD(model.parameters(),
                                lr=args.base_lr * hvd.size(),
                                momentum=args.momentum, weight_decay=args.wd)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        backward_passes_per_step=args.batches_per_allreduce)

    # Resume on rank 0, then broadcast both parameters and optimizer state.
    resume_epoch = 0
    for e in range(args.epochs - 1, -1, -1):
        path = args.checkpoint_format.format(epoch=e)
        if hvd.rank() == 0 and os.path.exists(path):
            ckpt = torch.load(path, map_location=device, weights_only=False)
            model.load_state_dict(ckpt["model"])
            optimizer.load_state_dict(ckpt["optimizer"])
            resume_epoch = e + 1
            print(f"Resuming from epoch {resume_epoch}", flush=True)
            break
    resume_epoch = int(hvd.broadcast(torch.tensor(resume_epoch), root_rank=0,
                                     name="resume_epoch"))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    rng = np.random.default_rng(1 + hvd.rank())
    train = [synthetic(rng, args.batch_size, device, fmt)
             for _ in range(args.steps_per_epoch * args.batches_per_allreduce)]
    val = synthetic(rng, args.val_batch_size, device, fmt)
    losses = []
    for epoch in range(resume_epoch, args.epochs):
        model.train()
        for batch_idx in range(args.steps_per_epoch):
            adjust_learning_rate(optimizer, epoch, batch_idx,
                                 args.steps_per_epoch)
            optimizer.zero_grad()
            # accumulate: one backward per local batch, one allreduce a
            # step (reference: batches_per_allreduce)
            step_loss = 0.0
            for k in range(args.batches_per_allreduce):
                x, y = train[batch_idx * args.batches_per_allreduce + k]
                loss = F.cross_entropy(model(x), y)
                loss.backward()
                step_loss += float(loss.detach()) / args.batches_per_allreduce
            optimizer.step()
            losses.append(step_loss)
            if hvd.rank() == 0:
                print(f"Epoch {epoch} step {batch_idx}: train loss "
                      f"{step_loss:.4f}", flush=True)

        # Validation, metrics averaged across ranks.
        model.eval()
        with torch.no_grad():
            out = model(val[0])
            val_loss = float(F.cross_entropy(out, val[1]))
            val_acc = float((out.argmax(1) == val[1]).float().mean())
        val_loss = metric_average(val_loss, f"avg_val_loss.{epoch}")
        val_acc = metric_average(val_acc, f"avg_val_acc.{epoch}")
        if hvd.rank() == 0:
            print(f"Epoch {epoch}: val loss {val_loss:.4f} "
                  f"acc {val_acc:.4f}", flush=True)
            path = args.checkpoint_format.format(epoch=epoch)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            torch.save({"model": model.state_dict(),
                        "optimizer": optimizer.state_dict()}, path)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    summary = {"example": "pytorch_imagenet_resnet50", "rank": hvd.rank(),
               "resumed_from": resume_epoch, "losses": losses}
    hvd.shutdown()
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
