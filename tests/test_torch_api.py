"""The port's top-level API against the JAX package's: the names its
torch front end exports (horovod_tpu/torch/__init__.py), the calls
tests/test_basics.py and tests/test_metrics.py make
(``mpi_threads_supported``, ``metrics_snapshot``), ``exchange_gradients``
(one rank here against the JAX package's, two gloo ranks against numpy),
the re-exports, and the JAX package's public names the port lacks by
design, pinned each with its reason."""

import importlib
import inspect
import os
import pkgutil
import sys
import tomllib

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.torch as jtorch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import metrics
from torch_engine_workers import exchange_session
from torch_ranks import REPO, spawn_ranks

sys.path.insert(0, os.path.dirname(__file__))
import mxnet_mock  # noqa: E402


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


def _grads(rng):
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layers": [rng.standard_normal(5).astype(np.float32),
                       (rng.standard_normal((2, 2)).astype(np.float32),)]}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return torch.from_numpy(tree)


@pytest.mark.parametrize("ours,theirs", [("none", "none"),
                                         ("fp16", "float16"),
                                         ("bf16", "bf16")])
def test_exchange_gradients_matches_the_reference(ours, theirs):
    """One port rank against the JAX package's ``exchange_gradients``
    over conftest's virtual ranks, each submitting the same leaves, so
    the average is the leaf whatever the mesh's size: the same nest back
    (dict keys, a list, a tuple), each result on its input's device,
    within f32 1e-6 relative (the reference sums 8 equal terms and
    divides), bf16 too; the IEEE fp16 wire within 2 of its ulps (2^-9
    relative), since the reference adds its 8 terms in fp16 and rounds
    the partial sums. The port's ``fp16`` is IEEE half, which the JAX
    package names ``float16`` (its ``fp16`` is its TPU-native bf16
    wire)."""
    g = _grads(np.random.default_rng(5))
    jhvd.shutdown()
    jhvd.init()
    try:
        ref = jhvd.exchange_gradients(
            g, compression=getattr(jhvd.Compression, theirs),
            name_prefix=f"ref.{theirs}")
        ref = {"w": np.asarray(ref["w"]),
               "l0": np.asarray(ref["layers"][0]),
               "l1": np.asarray(ref["layers"][1][0])}
    finally:
        jhvd.shutdown()
    hvd.init(device="cpu")
    grads = _as_torch(g)
    out = hvd.exchange_gradients(
        grads, compression=getattr(hvd.Compression, ours), to_host=True)
    assert list(out) == ["w", "layers"]
    assert isinstance(out["layers"], list)
    assert isinstance(out["layers"][1], tuple)
    got = {"w": out["w"], "l0": out["layers"][0], "l1": out["layers"][1][0]}
    for key, t in got.items():
        assert t.device == torch.device("cpu") and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), ref[key], atol=0,
                                   rtol=2 ** -9 if ours == "fp16" else 1e-6)


def test_exchange_gradients_names_reach_the_engine():
    """Each leaf is ``{name_prefix}.{i}`` in the JAX package's leaf
    order (dict keys sorted), so a repeated exchange hits the response
    cache once a leaf."""
    hvd.init(device="cpu")
    seen = []
    engine = hvd.runtime.live_state().engine
    enqueue = engine.enqueue

    def logged(op, tensor, name, **kw):
        seen.append(name)
        return enqueue(op, tensor, name, **kw)

    engine.enqueue = logged
    grads = _as_torch(_grads(np.random.default_rng(6)))
    hvd.exchange_gradients(grads, name_prefix="eg")
    assert seen == ["eg.0", "eg.1", "eg.2"]
    hits = engine.response_cache.hits
    again = hvd.exchange_gradients(grads, name_prefix="eg")
    assert engine.response_cache.hits - hits == 3
    assert torch.equal(again["layers"][0], grads["layers"][0])


def test_exchange_gradients_over_two_ranks():
    """Two gloo ranks, divergent gradients: the sum and the average are
    numpy's within f32 1e-6 relative, the fp16 wire's average within
    fp16's rounding, and the repeat hits the cache once a leaf."""
    n = 2
    rng = np.random.default_rng(7)
    inp = {k: [rng.standard_normal(shape).astype(np.float32)
               for _ in range(n)]
           for k, shape in (("w", (4, 3)), ("l0", (5,)), ("l1", (2, 2)))}
    got = spawn_ranks(n, exchange_session, inp)
    for r in range(n):
        for key in inp:
            total = inp[key][0] + inp[key][1]
            np.testing.assert_allclose(got[r]["sum"][key], total,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(got[r]["avg"][key], total / n,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(got[r]["fp16"][key], total / n,
                                       rtol=2e-3, atol=2e-3)
            assert np.array_equal(got[r]["fp16"][key], got[0]["fp16"][key])
        assert got[r]["repeat_hits"] == 3


def test_parallel_and_timeline_are_re_exported():
    """``horovod_tpu.parallel``'s three names and ``hvd.timeline``, as
    the JAX package exports them."""
    from horovod_tpu_torch.parallel import (MeshConfig, create_mesh,
                                            ulysses_attention)
    from horovod_tpu_torch.parallel import mesh, ulysses
    assert (create_mesh, MeshConfig) == (mesh.create_mesh, mesh.MeshConfig)
    assert ulysses_attention is ulysses.ulysses_attention
    import horovod_tpu.parallel as jpar
    for name in ("create_mesh", "MeshConfig", "ulysses_attention"):
        assert hasattr(jpar, name)
    assert hvd.timeline is importlib.import_module("horovod_tpu_torch.timeline")
    assert jhvd.timeline.__name__ == "horovod_tpu.timeline"


# The JAX package's public functions and classes that its port module
# lacks, each with the port's counterpart.
JAX_ONLY = {
    "horovod_tpu.optimizers.DistributedGradientTransform":
        "an optax transform; the port's DistributedOptimizer wraps a "
        "torch optimizer, and compiled_train_step captures the step",
    "horovod_tpu.optimizers.bucketed_apply_updates":
        "an optax apply over buckets; DistributedOptimizer's buckets "
        "and the captured step",
    "horovod_tpu.runtime.state":
        "the JAX runtime's global; the port's is runtime.live_state()",
    "horovod_tpu.ops.collectives.rank_index":
        "a device's index on the mesh axis; a port rank is a process: "
        "hvd.rank()",
    "horovod_tpu.ops.engine.register_wire_program_builder":
        "registers XLA wire programs; the port runs torch collectives, "
        "no XLA programs",
    "horovod_tpu.utils.devices.force_host_device_count":
        "virtual XLA CPU devices; the port's ranks are processes, with "
        "no virtual devices",
    "horovod_tpu.native.available":
        "the JAX package's optional library; native.py's loader builds "
        "the port's and raises when it cannot",
    "horovod_tpu.models.moe.moe_specs":
        "shard_map specs of the MoE leaves; the port's expert keys in "
        "optimizers.py",
}
# Modules of the JAX package with no port module (ROADMAP, Queue 1).
NO_PORT_MODULE = {"horovod_tpu.torch", "horovod_tpu.utils.compat",
                  "horovod_tpu.version"}


def _port_name(name):
    return "horovod_tpu_torch" + name[len("horovod_tpu"):]


def test_the_jax_only_names_are_pinned(monkeypatch):
    """Walk every module of horovod_tpu: each has a port module but the
    pinned three, and every public function and class a module defines
    (not one it imports) is in its port module but the pinned JAX-only
    names. ``horovod_tpu.mxnet`` loads over tests/mxnet_mock.py, as
    tests/test_mxnet_binding.py loads it."""
    monkeypatch.setitem(sys.modules, "mxnet", mxnet_mock)
    for mod in ("horovod_tpu.mxnet", "horovod_tpu_torch.mxnet"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    lacking, no_module = set(), set()
    for info in pkgutil.walk_packages(jhvd.__path__, "horovod_tpu."):
        if importlib.util.find_spec(_port_name(info.name)) is None:
            no_module.add(info.name)
            continue
        ours = importlib.import_module(_port_name(info.name))
        theirs = importlib.import_module(info.name)
        for name, obj in vars(theirs).items():
            if (inspect.isfunction(obj) or inspect.isclass(obj)) and \
                    obj.__module__ == info.name and \
                    not name.startswith("_") and not hasattr(ours, name):
                lacking.add(f"{info.name}.{name}")
    for mod in ("horovod_tpu.mxnet", "horovod_tpu_torch.mxnet"):
        sys.modules.pop(mod, None)
    assert no_module == NO_PORT_MODULE
    assert lacking == set(JAX_ONLY), (
        f"not in the port: {sorted(lacking - set(JAX_ONLY))}; "
        f"pinned but present: {sorted(set(JAX_ONLY) - lacking)}")


def test_horovodrun_torch_entry_point():
    """pyproject.toml's ``horovodrun-torch`` script resolves to the
    launcher's main, as ``horovodrun`` does to the JAX package's."""
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    module, func = scripts["horovodrun-torch"].split(":")
    from horovod_tpu_torch.run import run
    assert getattr(importlib.import_module(module), func) is run.main
    jmodule, jfunc = scripts["horovodrun"].split(":")
    assert jmodule == "horovod_tpu.run" and jfunc == func
