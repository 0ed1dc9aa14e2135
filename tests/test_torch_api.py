"""The port's top-level API against the JAX package's: the names its
torch front end exports (horovod_tpu/torch/__init__.py) and the calls
tests/test_basics.py and tests/test_metrics.py make
(``mpi_threads_supported``, ``metrics_snapshot``)."""

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.torch as jtorch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import metrics


@pytest.fixture(autouse=True)
def _fresh_runtime():
    yield
    hvd.shutdown()


def test_mpi_threads_supported():
    """tests/test_basics.py:29: True once initialized, as the reference
    answers; before init it raises NotInitializedError, as the
    reference's does."""
    with pytest.raises(hvd.NotInitializedError):
        hvd.mpi_threads_supported()
    hvd.init(device="cpu")
    jhvd.init()
    assert hvd.mpi_threads_supported() is True
    assert jhvd.mpi_threads_supported() is True
    assert jtorch.mpi_threads_supported() is True


def test_metrics_snapshot_reads_the_registry():
    """``hvd.metrics_snapshot()`` (tests/test_metrics.py:254, :275) is
    the registry's snapshot, before init too; after a callback's steps
    its step families read as the reference's test reads them."""
    from horovod_tpu_torch.callbacks import TelemetryCallback
    before = hvd.metrics_snapshot()
    assert before.keys() == metrics.snapshot().keys()
    assert "hvd_step_seconds" in before
    hvd.init(device="cpu")
    cb = TelemetryCallback(batch_size=16, skew_interval=2)
    count0 = hvd.metrics_snapshot()["hvd_step_seconds"]["values"].get(
        "", {"count": 0})["count"]
    for step in range(4):
        cb.on_batch_begin(step)
        torch.ones(64).sum()
        cb.on_batch_end(step)
    snap = hvd.metrics_snapshot()
    assert snap["hvd_step_seconds"]["values"][""]["count"] == count0 + 4
    assert snap["hvd_examples_per_sec"]["values"][""] > 0
    # one rank: a balanced mesh
    assert snap["hvd_step_time_skew"]["values"][""] == pytest.approx(1.0)
    assert snap["hvd_step_seconds_max"]["values"][""] > 0
    assert snap["hvd_step_seconds_median"]["values"][""] > 0
    hvd.allreduce(torch.ones(3), name="snap.ar")
    snap = hvd.metrics_snapshot()
    assert any(k.startswith("hvd_engine_") for k in snap)
    assert any(k.startswith("hvd_collective_") for k in snap)


@pytest.mark.parametrize("name", ["Compressor", "NoneCompressor",
                                  "FP16Compressor"])
def test_compressors_at_the_top_level(name):
    """The compressor classes the reference's torch front end exports:
    the same interface, and the same wire values on a tensor."""
    ours, theirs = getattr(hvd, name), getattr(jtorch, name)
    assert name in hvd.__all__
    assert issubclass(ours, hvd.Compressor)
    if name == "Compressor":
        with pytest.raises(NotImplementedError):
            ours.compress(torch.ones(2))
        return
    x = torch.from_numpy(np.linspace(-3, 3, 7, dtype=np.float32))
    (a, ca), (b, cb) = ours.compress(x), theirs.compress(x)
    assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(ours.decompress(a, ca), theirs.decompress(b, cb))
