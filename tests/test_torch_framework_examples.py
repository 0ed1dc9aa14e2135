"""The port's TensorFlow, Keras and MXNet examples (examples/torch_port/),
each run as a CPU subprocess (``--device cpu``) with the flags and the
asserted lines of tests/test_examples.py's checks of the JAX ones
(:33, :38, :45, :81, :92, :101, :110), plus one smoke case each for the
two scripts that file never runs (tensorflow_mnist.py and
keras_mnist.py), which must end with a finite, falling loss.

A module fixture starts the runs at most three at a time (importing
TensorFlow is heavy) and each test waits for its own; they live apart
from tests/test_torch_examples.py, whose fixture runs seven at once, so
that pytest-xdist's ``--dist loadfile`` places the two files on
different workers. A TensorFlow case skips where TensorFlow is not
installed; the MXNet cases run over tests/mxnet_mock.py (``--shim``).
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch_port")
TIMEOUT = 300
HAVE_TF = importlib.util.find_spec("tensorflow") is not None


def _jobs(tmp):
    """name -> (needs TensorFlow, the command line), longest first."""
    return {
        "keras_mnist_advanced": (True, (
            "keras_mnist_advanced.py",), {
                "CHECKPOINT_PATH": os.path.join(tmp, "keras_adv.keras")}),
        "tensorflow_synthetic_benchmark": (True, (
            "tensorflow_synthetic_benchmark.py", "--model", "MobileNetV2",
            "--batch-size", "2", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "1", "--num-iters", "2"), {}),
        "keras_mnist": (True, ("keras_mnist.py",), {}),
        "tensorflow_mnist": (True, ("tensorflow_mnist.py",), {}),
        "tensorflow_mnist_eager": (True, ("tensorflow_mnist_eager.py",), {
            "CHECKPOINT_DIR": os.path.join(tmp, "tf_mnist_eager")}),
        "tensorflow_word2vec": (True, (
            "tensorflow_word2vec.py", "--steps", "4"), {}),
        "mxnet_mnist": (False, ("mxnet_mnist.py", "--shim"), {}),
        "mxnet_imagenet_resnet50": (False, (
            "mxnet_imagenet_resnet50.py", "--shim"), {}),
    }


def _run(script, *flags, env_extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               HOROVOD_PROFILER_DISABLE="1", **(env_extra or {}))
    env.pop("HOROVOD_TPU_COORDINATOR", None)
    return subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), *flags,
         "--device", "cpu"], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=TIMEOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("framework_examples"))
    with ThreadPoolExecutor(3) as pool:
        yield {name: pool.submit(_run, *cmd, env_extra=env)
               for name, (tf, cmd, env) in _jobs(tmp).items()
               if HAVE_TF or not tf}


def _result(runs, name):
    if _jobs("")[name][0]:
        pytest.importorskip("tensorflow")
    proc = runs[name].result()
    assert proc.returncode == 0, (
        f"{name} failed\nstdout:\n{proc.stdout[-3000:]}\n"
        f"stderr:\n{proc.stderr[-3000:]}")
    return proc


def _summary(proc):
    """The JSON line a script ends with."""
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _falls(losses):
    return (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0])


def test_tensorflow_mnist(runs):
    """DistributedGradientTape as a context manager, a broadcast after
    the first step."""
    proc = _result(runs, "tensorflow_mnist")
    assert "[rank 0] final loss=" in proc.stdout
    assert _falls(_summary(proc)["losses"])


def test_tensorflow_mnist_eager(runs):
    proc = _result(runs, "tensorflow_mnist_eager")
    assert "Step 0" in proc.stdout


def test_tensorflow_word2vec_sparse_path(runs):
    proc = _result(runs, "tensorflow_word2vec")
    # the embedding gradients must actually take the IndexedSlices path
    assert "'sparse'" in proc.stdout
    assert "Final embedding norm" in proc.stdout
    assert _summary(proc)["grads"][0] == "sparse"


def test_keras_mnist(runs):
    """The callback set through ``model.fit``."""
    proc = _result(runs, "keras_mnist")
    assert _falls(_summary(proc)["losses"])


def test_keras_mnist_advanced(runs):
    proc = _result(runs, "keras_mnist_advanced")
    assert "Test loss" in proc.stdout


def test_tensorflow_synthetic_benchmark(runs):
    """The reference's named parity vehicle on the TF surface."""
    proc = _result(runs, "tensorflow_synthetic_benchmark")
    assert "Img/sec per" in proc.stdout
    assert _summary(proc)["img_sec_per_rank"] > 0


@pytest.mark.slow
def test_keras_imagenet_resnet50(tmp_path):
    """The full Keras ImageNet recipe at tiny settings. Slow, as its JAX
    counterpart is: TensorFlow trains ResNet-50 on the CPU, about a
    minute either way."""
    pytest.importorskip("tensorflow")
    proc = _run("keras_imagenet_resnet50.py", "--batch-size", "4",
                "--epochs", "2", "--samples", "8", "--num-classes", "10",
                "--warmup-epochs", "1", "--checkpoint-format",
                str(tmp_path / "kir_ckpt-{epoch}.keras"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Final loss" in proc.stdout


def test_mxnet_mnist_shim(runs):
    """broadcast_parameters -> DistributedTrainer -> the metric allreduce,
    with the loss falling, on the engine of the device asked for."""
    proc = _result(runs, "mxnet_mnist")
    assert "Epoch 1" in proc.stdout
    assert "DONE" in proc.stdout
    summary = _summary(proc)
    assert _falls(summary["losses"])
    assert (summary["engine_device"], summary["backend"]) == ("cpu", "gloo")


def test_mxnet_imagenet_resnet50_shim(runs):
    """The ImageNet recipe's warmup schedule over the shim."""
    proc = _result(runs, "mxnet_imagenet_resnet50")
    assert "lr" in proc.stdout
    assert "DONE" in proc.stdout
