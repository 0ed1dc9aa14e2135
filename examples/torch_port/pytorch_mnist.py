"""MNIST on horovod_tpu_torch.

Counterpart of examples/pytorch_mnist.py and examples/jax_mnist.py: the
same structure — ``hvd.init``, ``DistributedOptimizer`` over
``model.named_parameters()``, ``broadcast_parameters`` and
``broadcast_optimizer_state`` before training — with the input through
the port's ``hvd.data.DistributedDataset`` as in the JAX example: a
seeded global shuffle each epoch, this rank's equal-steps shard, batches
staged ahead on a background thread (``HOROVOD_DATA_PREFETCH`` deep),
and the JAX example's elastic-resumable iteration: the model, the
optimizer and the step live in an ``elastic.State``, the dataset's
position is attached to it (``hvd.data.attach_to_state``), the loop runs
under ``@elastic.run`` with a ``commit()`` after every step, so a
recovered job resumes mid-epoch from its last commit; at the end a fresh
dataset loaded from the committed position shows that contract and the
script prints ``resume OK``. The data is synthetic MNIST-shaped (nothing
is downloaded): 640 fixed samples whose labels a linear map of the
pixels decides, so the loss falls epoch over epoch. Runs on the card by
default, on the CPU with ``--device cpu``; ``python -m
horovod_tpu_torch.run -np 2 python examples/torch_port/pytorch_mnist.py``
trains on two ranks.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic

parser = argparse.ArgumentParser(
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--epochs", type=int, default=2)
parser.add_argument("--batch-size", type=int, default=32,
                    help="samples a rank a step")
parser.add_argument("--lr", type=float, default=0.01)
parser.add_argument("--momentum", type=float, default=0.5)
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = parser.parse_args()

NUM_SAMPLES = 640
SEED = 1234


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(784, 128)
        self.fc2 = nn.Linear(128, 10)

    def forward(self, x):
        x = x.view(-1, 784)
        return F.log_softmax(self.fc2(F.relu(self.fc1(x))), dim=1)


def synthetic_mnist(n, seed):
    """``n`` MNIST-shaped images and labels; the same on every rank."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 1, 28, 28), np.float32)
    w = rng.standard_normal((784, 10), np.float32)
    y = (x.reshape(n, 784) @ w).argmax(1)
    return torch.from_numpy(x), torch.from_numpy(y)


def main():
    hvd.init(device=args.device)
    device = hvd.runtime.device()
    torch.manual_seed(42 + hvd.rank())
    model = Net().to(device)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr,
                                momentum=args.momentum)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())

    # Everyone starts from rank 0's weights and optimizer state
    # (reference: pytorch_mnist.py hvd.broadcast_parameters /
    # broadcast_optimizer_state).
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    data = synthetic_mnist(NUM_SAMPLES, 7)
    ds = hvd.data.DistributedDataset(
        data, batch_size=args.batch_size, seed=SEED, device=device.type)

    # The iterator position (epoch, seed, segment history) commits into
    # the elastic state beside the model, so a rollback rewinds the
    # input too: a recovered job resumes mid-epoch where the last commit
    # left it, re-sharded across the survivors if the membership shrank.
    state = elastic.State(model=model, optimizer=optimizer, step=0)
    hvd.data.attach_to_state(state, ds)
    losses = []

    @elastic.run
    def train(state):
        while ds.epoch < args.epochs:
            epoch = ds.epoch
            total, steps = 0.0, 0
            for data, target in ds:  # one epoch (or its restored rest)
                optimizer.zero_grad()
                loss = F.nll_loss(model(data), target)
                loss.backward()
                optimizer.step()
                total, steps = total + float(loss.detach()), steps + 1
                state.step += 1
                state.commit()  # the model AND the iterator position
            if steps:  # an empty restored remainder yields none
                losses.append(total / steps)
                print(f"[rank {hvd.rank()}] epoch {epoch} "
                      f"loss={losses[-1]:.4f} ({steps} steps, input wait "
                      f"{ds.take_wait() * 1e3:.1f} ms)", flush=True)

    train(state)

    # The resume contract without killing anyone: a fresh dataset loaded
    # from the committed position yields what a restarted worker would
    # replay. The last commit came inside the last epoch's loop, so the
    # position is "last epoch, fully consumed": nothing is replayed, and
    # consuming the empty remainder rolls into the next epoch.
    ds2 = hvd.data.DistributedDataset(
        data, batch_size=args.batch_size, seed=SEED, device=device.type)
    ds2.load_state_dict(state.data_iter)
    assert ds2.epoch == args.epochs - 1 and ds2.steps_remaining == 0, (
        ds2.epoch, ds2.steps_remaining)
    next(iter(ds2), None)
    assert ds2.epoch == args.epochs
    print(f"resume OK: committed position is epoch {args.epochs - 1} "
          f"consumed, step {int(state.step)}", flush=True)
    summary = {"example": "pytorch_mnist", "rank": hvd.rank(),
               "losses": losses, "step": int(state.step)}
    ds.close()
    ds2.close()
    hvd.shutdown()
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
