"""The port's own examples (examples/torch_port/), each run as a CPU
subprocess at a tiny size, in the style of tests/test_examples.py: the
assertion is a clean exit, each script's own checks and the lines it
prints.

A process of the port spends most of its few seconds importing torch, so
the module starts every example at once (each with two threads) and
each test waits for its own. The card runs two of them at full width in
chip_smoke.py's examples phase (tests/test_torch_cuda_examples.py).
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch_port")
TIMEOUT = 300
LONG_CONTEXT = ("--device", "cpu", "--d-model", "64", "--layers", "2",
                "--seq-len", "128", "--steps", "3")
RESNET = ("--device", "cpu", "--image-size", "32", "--batch-size", "2",
          "--val-batch-size", "2", "--epochs", "2", "--steps-per-epoch", "2",
          "--batches-per-allreduce", "1")


def _jobs(ckpt):
    """name -> the command lines one test runs, in order."""
    fmt = os.path.join(ckpt, "ckpt-{epoch}.pth")
    return {
        "ring_flash": [("transformer_long_context.py", *LONG_CONTEXT,
                        "--attention", "ring-flash", "--sp", "2",
                        "--window", "96", "--kv-heads", "4")],
        "ulysses": [("transformer_long_context.py", *LONG_CONTEXT,
                     "--attention", "ulysses", "--sp", "2")],
        "generate": [("transformer_long_context.py", *LONG_CONTEXT,
                      "--attention", "flash", "--positional", "rope",
                      "--generate", "8")],
        "resnet_resume": [
            ("pytorch_imagenet_resnet50.py", *RESNET,
             "--checkpoint-format", fmt),
            ("pytorch_imagenet_resnet50.py", *RESNET,
             "--checkpoint-format", fmt)],
        "mnist": [("pytorch_mnist.py", "--device", "cpu")],
        "synthetic": [("pytorch_synthetic_benchmark.py", "--device", "cpu",
                       "--batch-size", "2", "--image-size", "32",
                       "--num-warmup-batches", "1",
                       "--num-batches-per-iter", "1", "--num-iters", "2")],
        "spark": [("spark_tabular.py", "--device", "cpu")],
    }


def _run_all(commands):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               HOROVOD_PROFILER_DISABLE="1")
    env.pop("HOROVOD_TPU_COORDINATOR", None)
    out = []
    for script, *flags in commands:
        proc = subprocess.run(
            [sys.executable, os.path.join(EXAMPLES, script), *flags],
            env=env, cwd=REPO, capture_output=True, text=True,
            timeout=TIMEOUT)
        out.append(proc)
        if proc.returncode != 0:
            break
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs = _jobs(str(tmp_path_factory.mktemp("ckpt")))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(_run_all, cmds)
                   for name, cmds in jobs.items()}
        yield futures


def _result(runs, name):
    procs = runs[name].result()
    for proc in procs:
        assert proc.returncode == 0, (
            f"{name} failed\nstdout:\n{proc.stdout[-3000:]}\n"
            f"stderr:\n{proc.stderr[-3000:]}")
    return procs


def _summary(proc):
    """The JSON line a script ends with."""
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _falls(losses):
    return (all(x == x and abs(x) < float("inf") for x in losses)
            and losses[-1] < losses[0])


def test_long_context_ring_flash(runs):
    """The ring of 2 local shards through the kernels' plain versions,
    with a window and GQA (the band tiles' path)."""
    proc, = _result(runs, "ring_flash")
    assert "mesh: dp=1 sp=2 tp=1" in proc.stdout
    assert "tokens/sec" in proc.stdout
    out = _summary(proc)
    assert _falls(out["losses"]) and out["head_dim"] == 8
    # on the CPU a wrapper runs its plain version and counts no launch
    assert not any(out["launches"].values())


def test_long_context_ulysses(runs):
    proc, = _result(runs, "ulysses")
    assert "tokens/sec" in proc.stdout
    assert _falls(_summary(proc)["losses"])


def test_long_context_rope_generate(runs):
    """RoPE training, then decoding through the serve engine."""
    proc, = _result(runs, "generate")
    assert "tokens/sec" in proc.stdout
    assert "generated 8 tokens" in proc.stdout


def test_imagenet_resnet50_resumes(runs):
    first, second = _result(runs, "resnet_resume")
    assert "Epoch 1: val loss" in first.stdout
    assert _falls(_summary(first)["losses"])
    # the second invocation resumes past the trained epochs
    assert "Resuming from epoch 2" in second.stdout
    assert _summary(second) == {"example": "pytorch_imagenet_resnet50",
                                "rank": 0, "resumed_from": 2, "losses": []}


def test_mnist(runs):
    """Under ``@elastic.run`` with the dataset attached to the state: a
    falling loss, then a fresh dataset loaded at the committed position
    (the last epoch, consumed) rolls into the next epoch."""
    proc, = _result(runs, "mnist")
    assert "epoch 1 loss=" in proc.stdout
    assert ("resume OK: committed position is epoch 1 consumed, step 40"
            in proc.stdout)
    out = _summary(proc)
    assert _falls(out["losses"]) and out["step"] == 40


def test_synthetic_benchmark(runs):
    proc, = _result(runs, "synthetic")
    assert "Img/sec per rank" in proc.stdout
    assert _summary(proc)["img_sec_per_rank"] > 0


def test_spark_tabular(runs):
    """Over spark.run's local backend, one process a rank, as
    tests/test_torch_spark.py runs it."""
    proc, = _result(runs, "spark")
    assert "rank-ordered results" in proc.stdout
    assert "OK" in proc.stdout
