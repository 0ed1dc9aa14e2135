"""Weak scaling of data-parallel training: the reference's headline
metric.

Counterpart of bench_scaling.py: the same 784 -> [hidden] * depth -> 10
ReLU MLP on the same seeded data, trained with SGD 0.01 through the
port's ``DistributedOptimizer`` at a fixed per-rank batch on 1, 2, 4,
... ranks, reporting

    efficiency(n) = (img/s(n) / n) / img/s(1) * 100

A port rank is a process, so size n launches n processes through the
port's launcher (run/run.py): gloo on the CPU (``--device cpu``; the cap
is ``HOROVOD_SCALING_DEVICES``, default 8, as the reference's), NCCL with
one card a rank on the card (the cap is the number of cards). One card
gives the size-1 row alone: NCCL refuses two ranks on one card, and no
row is made up.

    python -m horovod_tpu_torch.bench.scaling [--device cpu]

``HOROVOD_SCALING_BATCH`` (64), ``_HIDDEN`` (1024), ``_DEPTH`` (4),
``_STEPS`` (8), ``_WARMUP`` (2) and ``_REPEATS`` (1, the median kept)
override the defaults, as they do the reference's. Each size prints a
``# n=...`` line; the last line is the reference's JSON:

    {"metric": "weak_scaling_efficiency", "value": E, "unit": "%",
     "vs_baseline": E / 90, "per_n": {...}, "devices": N, ...}
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from .. import hardware

DEFAULTS = {"batch": 64, "hidden": 1024, "depth": 4, "steps": 8,
            "warmup": 2, "repeats": 1}


def settings():
    """The defaults under their ``HOROVOD_SCALING_*`` overrides."""
    return {k: int(os.environ.get(f"HOROVOD_SCALING_{k.upper()}", v))  # hvdlint: disable=HVD003 -- the harness's own sizes, read as bench_scaling.py reads them, not a knob of the library
            for k, v in DEFAULTS.items()}


def sizes(device):
    """1, 2, 4, ... up to the cap: HOROVOD_SCALING_DEVICES (default 8)
    on the CPU, the number of cards on the card (and the variable, where
    it is set, below that)."""
    cap = os.environ.get("HOROVOD_SCALING_DEVICES")  # hvdlint: disable=HVD003 -- the harness's own cap, read as bench_scaling.py reads it
    if device.startswith("cuda"):
        total = torch.cuda.device_count()
        if cap:
            total = min(total, int(cap))
    else:
        total = int(cap or 8)
    out, n = [], 1
    while n <= total:
        out.append(n)
        n *= 2
    return out


def model_and_data(n, batch_per_chip, hidden, depth):
    """The reference's draws in its order: ``RandomState(0)``, each
    layer's weight ``randn(prev, h) * 0.05`` (biases zero), then the
    global batch of ``batch_per_chip * n`` rows and its ``randint(0, 10)``
    labels. Returns ({name: array}, X, Y), the names the reference's."""
    rng = np.random.RandomState(0)
    params, prev = {}, 784
    for i, h in enumerate([hidden] * depth + [10]):
        params[f"w{i}"] = rng.randn(prev, h).astype(np.float32) * 0.05
        params[f"b{i}"] = np.zeros((h,), np.float32)
        prev = h
    batch = batch_per_chip * n
    x = rng.randn(batch, 784).astype(np.float32)
    y = rng.randint(0, 10, (batch,))
    return params, x, y


class Harness:
    """One rank's share of the step: the MLP's parameters on this rank's
    device, SGD 0.01 through ``DistributedOptimizer``, and this rank's
    rows of the global batch (the reference's ``P("hvd")`` shard)."""

    def __init__(self, batch_per_chip, hidden, depth):
        import horovod_tpu_torch as hvd
        n, r = hvd.size(), hvd.rank()
        dev = hvd.runtime.device()
        arrays, x, y = model_and_data(n, batch_per_chip, hidden, depth)
        self.depth = depth
        self.params = {k: torch.tensor(v, device=dev).requires_grad_()
                       for k, v in sorted(arrays.items())}
        rows = slice(r * batch_per_chip, (r + 1) * batch_per_chip)
        self.x = torch.tensor(x[rows], device=dev)
        self.y = torch.tensor(y[rows], device=dev)
        self.optimizer = hvd.DistributedOptimizer(
            torch.optim.SGD(self.params.values(), lr=0.01),
            named_parameters=self.params.items())

    def loss(self):
        h = self.x
        for i in range(self.depth + 1):
            h = h @ self.params[f"w{i}"] + self.params[f"b{i}"]
            if i < self.depth:
                h = torch.relu(h)
        return F.cross_entropy(h, self.y)

    def step(self):
        self.optimizer.zero_grad()
        loss = self.loss()
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def numpy_params(self):
        return {k: p.detach().cpu().numpy().copy()
                for k, p in self.params.items()}


def run_rank(batch_per_chip, hidden, depth, steps, warmup, repeats):
    """This rank's timed run after ``hvd.init``: ``warmup`` steps, then
    ``repeats`` passes of ``steps`` steps, each ended by reading the
    loss (which waits for the card). Returns the median pass's global
    img/s (every rank's rows), as the reference keeps it."""
    import time

    import horovod_tpu_torch as hvd
    h = Harness(batch_per_chip, hidden, depth)
    for _ in range(warmup):
        float(h.step())
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = h.step()
        float(loss)
        samples.append(batch_per_chip * hvd.size() * steps
                       / (time.perf_counter() - t0))
    return float(np.median(samples)), float(loss)


def _worker(device, out_dir):
    """A launched rank: ``init()`` over the launcher's variables, the
    timed run, and rank 0's figures to ``out_dir``."""
    import horovod_tpu_torch as hvd
    hvd.init(device=device)
    s = settings()
    img_sec, loss = run_rank(s["batch"], s["hidden"], s["depth"],
                             s["steps"], s["warmup"], s["repeats"])
    if hvd.rank() == 0:
        with open(os.path.join(out_dir, f"n{hvd.size()}.json"), "w") as f:
            json.dump({"img_sec": img_sec, "loss": loss,
                       "backend": torch.distributed.get_backend()}, f)
    hvd.shutdown()


def run_weak_scaling(device):
    """Every size launched in turn. Returns ({n: img/s total},
    {n: efficiency %}, {n: final loss}, backend)."""
    from ..run.run import launch
    throughput, losses, backend = {}, {}, None
    env = dict(os.environ)
    env.setdefault("HOROVOD_PROFILER_DISABLE", "1")
    with tempfile.TemporaryDirectory() as out_dir:
        for n in sizes(device):
            rc = launch(n, [sys.executable, "-m",
                            "horovod_tpu_torch.bench.scaling", "--worker",
                            "--device", device, "--out", out_dir],
                        start_timeout=120, env=env)
            if rc != 0:
                raise RuntimeError(f"size {n} exited {rc}")
            with open(os.path.join(out_dir, f"n{n}.json")) as f:
                row = json.load(f)
            throughput[n], losses[n] = row["img_sec"], row["loss"]
            backend = row["backend"]
    base = throughput[1]
    efficiency = {n: (t / n) / base * 100.0 for n, t in throughput.items()}
    return throughput, efficiency, losses, backend


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)  # a launched rank
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.device, args.out)
        return
    card = None
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu")
        card = hardware.card_line()
        print(card, flush=True)
    throughput, efficiency, losses, backend = run_weak_scaling(args.device)
    top = max(efficiency)
    for n in sorted(throughput):
        print(f"# n={n}: {throughput[n]:.1f} img/s total, efficiency "
              f"{efficiency[n]:.1f}%, loss {losses[n]:.4f}", flush=True)
    if top == 1:
        print("# one rank only: the curve past size 1 needs more "
              + ("cards (NCCL refuses two ranks on one card)"
                 if args.device.startswith("cuda")
                 else "slots (HOROVOD_SCALING_DEVICES)"), flush=True)
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": round(efficiency[top], 2),
        "unit": "%",
        "vs_baseline": round(efficiency[top] / 90.0, 3),
        "per_n": {str(n): round(efficiency[n], 2) for n in efficiency},
        "devices": top,
        "img_sec": {str(n): throughput[n] for n in throughput},
        "settings": settings(),
        "device": args.device,
        "backend": backend,
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
