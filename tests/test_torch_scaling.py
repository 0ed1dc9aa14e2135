"""The port's weak-scaling harness (horovod_tpu_torch/bench/scaling.py)
against bench_scaling.py.

Parity: the harness's step on 2 gloo ranks, after 1 and 3 SGD steps,
against the reference's step built here as bench_scaling.py:88-110
builds it (``DistributedOptimizer(optax.sgd(0.01))`` under ``shard_map``
on 2 of conftest's virtual devices), on the same seeded draws. Protocol:
the counterpart of tests/test_scaling.py's metric-line test at a tiny
size. tests/test_scaling.py's wall-clock floor has no counterpart: the
reference itself fails it (ROADMAP.md).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu_torch.bench import scaling
from torch_rank_workers import scaling_steps
from torch_ranks import REPO, spawn_ranks

N = 2
BATCH, HIDDEN, DEPTH = 8, 32, 2
SNAPSHOTS = (1, 3)


def _reference(snapshots):
    """bench_scaling.py's step on N virtual devices: its parameters after
    each step count in ``snapshots``."""
    jhvd.shutdown()
    jhvd.init(num_ranks=N)
    try:
        mesh = jhvd.mesh()
        arrays, x, y = scaling.model_and_data(N, BATCH, HIDDEN, DEPTH)
        params = {k: jnp.asarray(v) for k, v in arrays.items()}
        tx = jhvd.DistributedOptimizer(optax.sgd(0.01))
        opt_state = tx.init(params)

        def per_shard(params, opt_state, xb, yb):
            def loss_fn(p):
                h = xb
                for i in range(DEPTH + 1):
                    h = h @ p[f"w{i}"] + p[f"b{i}"]
                    if i < DEPTH:
                        h = jax.nn.relu(h)
                return optax.softmax_cross_entropy_with_integer_labels(
                    h, yb).mean()

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        step = jax.jit(jax.shard_map(
            per_shard, mesh=mesh, in_specs=(P(), P(), P("hvd"), P("hvd")),
            out_specs=(P(), P(), P()), check_vma=False))
        X = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("hvd")))
        Y = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("hvd")))
        out, done = {}, 0
        for k in snapshots:
            while done < k:
                params, opt_state, _ = step(params, opt_state, X, Y)
                done += 1
            out[k] = {n: np.asarray(v) for n, v in params.items()}
        return out
    finally:
        jhvd.shutdown()


def test_the_draws_are_the_references():
    """``model_and_data`` draws as bench_scaling.py does: RandomState(0),
    the weights * 0.05 layer by layer, zero biases, then the global
    batch and its labels."""
    rng = np.random.RandomState(0)
    arrays, x, y = scaling.model_and_data(N, BATCH, HIDDEN, DEPTH)
    prev = 784
    for i, h in enumerate([HIDDEN] * DEPTH + [10]):
        np.testing.assert_array_equal(
            arrays[f"w{i}"], rng.randn(prev, h).astype(np.float32) * 0.05)
        np.testing.assert_array_equal(arrays[f"b{i}"], np.zeros(h))
        prev = h
    np.testing.assert_array_equal(
        x, rng.randn(N * BATCH, 784).astype(np.float32))
    np.testing.assert_array_equal(y, rng.randint(0, 10, (N * BATCH,)))
    assert scaling.DEFAULTS == {"batch": 64, "hidden": 1024, "depth": 4,
                                "steps": 8, "warmup": 2, "repeats": 1}


def test_two_ranks_match_the_reference_step():
    """After 1 and 3 steps every rank's parameters equal the reference's
    within f32 1e-6 relative (the gradient mean over each rank's rows,
    averaged over the ranks, as the reference's shards average)."""
    got = spawn_ranks(N, scaling_steps, BATCH, HIDDEN, DEPTH, SNAPSHOTS)
    ref = _reference(SNAPSHOTS)
    for k in SNAPSHOTS:
        for r in range(N):
            assert got[r][k].keys() == ref[k].keys()
            for name, want in ref[k].items():
                np.testing.assert_allclose(
                    got[r][k][name], want, rtol=1e-6, atol=1e-7,
                    err_msg=f"rank {r}, step {k}, {name}")
    # the steps moved the parameters
    assert not np.array_equal(ref[3]["w0"], ref[1]["w0"])


def test_the_harness_emits_the_metric_line():
    """``python -m horovod_tpu_torch.bench.scaling --device cpu`` at a
    tiny size, capped at 2 ranks: a ``# n=`` line a size and the
    reference's JSON as the last line."""
    env = dict(os.environ, HOROVOD_SCALING_DEVICES="2",
               HOROVOD_SCALING_HIDDEN="32", HOROVOD_SCALING_DEPTH="1",
               HOROVOD_PROFILER_DISABLE="1", OMP_NUM_THREADS="2")
    env.pop("HOROVOD_TPU_COORDINATOR", None)
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench.scaling",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    payload = json.loads(lines[-1])
    assert {"metric", "value", "unit", "vs_baseline", "per_n",
            "devices"} <= payload.keys()
    assert payload["metric"] == "weak_scaling_efficiency"
    assert payload["unit"] == "%" and payload["value"] > 0
    assert set(payload["per_n"]) == {"1", "2"}
    assert payload["per_n"]["1"] == 100.0 and payload["devices"] == 2
    assert payload["vs_baseline"] == round(payload["value"] / 90.0, 3)
    assert payload["backend"] == "gloo"
    assert payload["settings"]["hidden"] == 32
    assert all(v > 0 for v in payload["img_sec"].values())
    assert sum(line.startswith("# n=") for line in lines) == 2
