"""Distributed tabular training through horovod_tpu_torch.spark.run.

Counterpart of examples/spark_tabular.py (whose own analog is the
reference's keras_spark_rossmann.py): a tabular regression with a known
ground truth trained data-parallel on Spark executors, results gathered
on the driver in rank order. The features are synthetic (the Rossmann
CSVs are not shippable); the Spark mechanics (rank assignment by host
hash, ``hvd.init()`` inside each task, rank-ordered results) are the
reference's.

Runs on a real pyspark cluster when one is importable; otherwise
``backend="local"`` spawns one process per rank with the same protocol.
Each task trains on the card by default (``--device cpu``: on the CPU);
several tasks sharing one card join a gloo group first, since NCCL
refuses two ranks on one card.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import horovod_tpu_torch.spark

parser = argparse.ArgumentParser()
parser.add_argument("--num-proc", type=int,
                    default=int(os.environ.get("SPARK_NUM_PROC", "2")))
parser.add_argument("--steps", type=int, default=300)
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def train(num_features, steps, device):
    """Runs inside each Spark task / local rank process."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    if device == "cuda":
        rank = int(os.environ["HOROVOD_RANK"])
        size = int(os.environ["HOROVOD_SIZE"])
        if torch.cuda.device_count() < size:
            # tasks sharing a card: a gloo group over the job's store,
            # which init() adopts
            dist.init_process_group(
                "gloo", rank=rank, world_size=size,
                store=dist.PrefixStore("example/spark/",
                                       hvd.runtime.job_store()))
        device = torch.device("cuda", rank % torch.cuda.device_count())
    hvd.init(device=device)
    rng = np.random.default_rng(7)  # same data every rank; sharded below
    true_w = rng.standard_normal((num_features, 1)).astype(np.float32)
    X = rng.standard_normal((256, num_features)).astype(np.float32)
    y = X @ true_w + 0.01 * rng.standard_normal((256, 1)).astype(np.float32)

    dev = hvd.runtime.device()
    w = torch.zeros(num_features, 1, device=dev, requires_grad=True)
    hvd.broadcast_parameters({"w": w}, root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.Adam([w], lr=0.05),
                                   named_parameters=[("w", w)])

    # each process contributes its rank's rows
    rows = 256 // hvd.size()
    lo = hvd.rank() * rows
    Xs = torch.from_numpy(X[lo:lo + rows]).to(dev)
    ys = torch.from_numpy(y[lo:lo + rows]).to(dev)
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.mean((Xs @ w - ys) ** 2)
        loss.backward()
        opt.step()
    rank = hvd.rank()
    final = float(loss.detach())
    w_err = float(np.abs(w.detach().cpu().numpy() - true_w).max())
    hvd.shutdown()
    return {"rank": rank, "loss": final, "w_err": w_err}


def main():
    args = parser.parse_args()
    try:
        import pyspark  # noqa: F401
        backend = "spark"
    except ImportError:
        backend = "local"
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        ".."))
    env = {"PYTHONPATH": os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    results = horovod_tpu_torch.spark.run(
        train, args=(8, args.steps, args.device), num_proc=args.num_proc,
        backend=backend, env=env)
    assert [r["rank"] for r in results] == list(range(args.num_proc))
    print("rank-ordered results:")
    for r in results:
        print(f"  rank {r['rank']}: loss {r['loss']:.6f} "
              f"w_err {r['w_err']:.4f}")
    assert all(r["w_err"] < 0.05 for r in results), "did not converge"
    print("OK")


if __name__ == "__main__":
    main()
