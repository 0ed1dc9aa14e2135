"""The port's eager engine (horovod_tpu_torch/ops/engine.py) against the
JAX package's (horovod_tpu/ops/engine.py).

The same per-rank inputs, drawn from a seed with numpy, go through the
reference's engine — ``hvd.init(num_ranks=2)`` over two of the
conftest's virtual devices, every rank's tensor submitted in this
process with ``rank=r`` — and through the port on two gloo ranks, each a
process (tests/torch_ranks.py; once for the module), each submitting its
own tensors in its own order. Sums are compared exactly (integer-valued
inputs), f32 means within 1e-6 relative; the mismatch, duplicate-name
and stall messages character for character; the response cache's hits;
``profiler.txt``'s lines (counters and message sizes: the times are the
host's). One-rank behavior (the overlap pipeline, device-resident
results, the wire-layout cache, the in-place bucket, waits outside the
engine lock) runs in this
process. Behavioral specs: tests/test_engine.py, test_overlap_pipeline.py,
test_device_resident.py and test_collectives.py. The card's side
(streams, events, no host copies) is tests/test_torch_cuda_engine.py.
"""

import logging
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.ops import engine as jengine
from horovod_tpu_torch.ops import engine as pengine
from horovod_tpu.ops import collectives as jcollectives
from horovod_tpu_torch.ops import collectives as pcollectives
from torch_engine_workers import (engine_session, hierarchical_session,
                                  shutdown_propagation, stall_session)
from torch_ranks import spawn_ranks

N = 2
RNG = np.random.default_rng(13)
PORT_ENV = {"HOROVOD_TPU_TICKER_DISABLE": "1",
            "HOROVOD_PROFILER_DISABLE": "0"}


def _ints(shape, dtype=np.float32):
    return RNG.integers(-8, 9, shape).astype(dtype)


def _per_rank(fn):
    return {r: fn(r) for r in range(N)}


def _script():
    """The steps of the parity script (tests/torch_engine_workers.py)."""
    ar = {
        "ar.sum_f32": ({r: _ints((3, 4)) for r in range(N)},
                       {"average": False}),
        "ar.mean_f32": ({r: RNG.standard_normal(5).astype(np.float32)
                         for r in range(N)}, {}),
        "ar.sum_i32": ({r: _ints((4,), np.int32) for r in range(N)},
                       {"average": False}),
        "ar.mean_i32": ({r: _ints((4,), np.int32) for r in range(N)}, {}),
        "ar.sum_bf16": ({r: (_ints((6,)), "bfloat16") for r in range(N)},
                        {"average": False}),
        "ar.mean_f16": ({r: _ints((6,), np.float16) for r in range(N)}, {}),
        "ar.mean_f64": ({r: RNG.standard_normal(3) for r in range(N)}, {}),
        "ar.fp16_wire": ({r: _ints((5,)) * 0.25 for r in range(N)},
                         {"compression": "fp16"}),
        "ar.scalar": ({r: np.array(float(r + 1), np.float32)
                       for r in range(N)}, {"average": False}),
    }
    for i in range(16):
        ar[f"fuse.{i:02d}"] = ({r: _ints((1 + i * 7,)) for r in range(N)},
                               {"average": False})
    names = sorted(ar)
    steps = [{"kind": "allreduce",
              "order": {0: names, 1: names[::-1]},
              "items": {n: {"data": d, "kw": kw}
                        for n, (d, kw) in ar.items()}}]
    steps.append({"kind": "allgather", "order": {0: ["ag.uneven", "ag.3d"],
                                                 1: ["ag.3d", "ag.uneven"]},
                  "items": {"ag.uneven": {"data": {0: _ints((3, 2)),
                                                   1: _ints((5, 2))}},
                            "ag.3d": {"data": {0: _ints((2, 3, 4)),
                                               1: _ints((1, 3, 4))}}}})
    steps.append({"kind": "broadcast", "order": {0: ["bc.f32", "bc.bool"],
                                                 1: ["bc.bool", "bc.f32"]},
                  "items": {"bc.f32": {"data": _per_rank(
                      lambda r: _ints((6,))), "kw": {"root_rank": 1}},
                      "bc.bool": {"data": _per_rank(
                          lambda r: RNG.integers(0, 2, (4,)).astype(bool)),
                          "kw": {"root_rank": 0}}}})
    steps.append({"kind": "alltoall", "order": {0: ["a2a"], 1: ["a2a"]},
                  "items": {"a2a": {"data": _per_rank(
                      lambda r: _ints((4, 3)))}}})
    f32 = np.zeros(3, np.float32)
    errors = {
        "err.dtype": {0: ("allreduce", f32, {}),
                      1: ("allreduce", f32.astype(np.int32), {})},
        "err.shape": {0: ("allreduce", np.zeros(2, np.float32), {}),
                      1: ("allreduce", np.zeros(3, np.float32), {})},
        "err.op": {0: ("allreduce", f32, {}), 1: ("allgather", f32, {})},
        "err.root": {0: ("broadcast", f32, {"root_rank": 0}),
                     1: ("broadcast", f32, {"root_rank": 1})},
        "err.rank0": {r: ("allgather", np.array(1.0, np.float32), {})
                      for r in range(N)},
        "err.gdim": {0: ("allgather", np.zeros((2, 3), np.float32), {}),
                     1: ("allgather", np.zeros((2, 4), np.float32), {})},
        "err.gndim": {0: ("allgather", np.zeros((2, 3), np.float32), {}),
                      1: ("allgather", np.zeros((2, 3, 1), np.float32), {})},
        "err.a2a_shape": {0: ("alltoall", np.zeros(4, np.float32), {}),
                          1: ("alltoall", np.zeros(6, np.float32), {})},
        "err.a2a_div": {r: ("alltoall", np.zeros(3, np.float32), {})
                        for r in range(N)},
    }
    enames = sorted(errors)
    steps.append({"kind": "mixed", "order": {0: enames, 1: enames[::-1]},
                  "items": errors})
    return steps


SCRIPT = _script()
STEADY = [f"steady.{i}" for i in range(4)]
STEADY_ROUNDS = 3


def _jax_array(a):
    if isinstance(a, tuple):
        return a[0].astype(ml_dtypes.bfloat16)
    return a


def _as_np(a):
    if isinstance(a, tuple):
        return a[0]
    if getattr(a, "dtype", None) == ml_dtypes.bfloat16:
        return np.asarray(a, np.float32)
    return np.asarray(a)


def _jax_submit(kind, arr, name, r, kw):
    kw = dict(kw)
    if kw.pop("compression", None) == "fp16":
        kw["compression"] = jhvd.Compression.fp16
    if kind == "allreduce":
        return jhvd.allreduce_async(arr, name=name, rank=r, **kw)
    if kind == "allgather":
        return jhvd.allgather_async(arr, name=name, rank=r)
    if kind == "broadcast":
        return jhvd.broadcast_async(arr, kw["root_rank"], name=name, rank=r)
    return jhvd.state().engine.enqueue(jengine.ALLTOALL, arr, name, rank=r)


def run_reference_script(script):
    """The script through the JAX engine, every rank submitted here:
    {rank: {name: outcome}}."""
    out = {r: {} for r in range(N)}
    for step in script:
        kind, items = step["kind"], step["items"]
        handles = {}
        for r in range(N):
            for name in step["order"][r]:
                item = items[name]
                k, arr, kw = (item[r] if kind == "mixed"
                              else (kind, item["data"][r],
                                    item.get("kw", {})))
                handles[(r, name)] = _jax_submit(k, _jax_array(arr), name,
                                                 r, kw)
        for (r, name) in sorted(handles, key=lambda k: (k[1], k[0])):
            try:
                out[r][name] = jhvd.synchronize(handles[(r, name)])[r]
            except jhvd.HorovodError as e:
                out[r][name] = ("error", type(e).__name__, str(e))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory, request):
    path = tmp_path_factory.mktemp("ref") / "profiler.txt"
    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_PROFILER_PATH", str(path))
    mp.setenv("HOROVOD_PROFILER_DISABLE", "0")
    jhvd.shutdown()
    jhvd.init(num_ranks=N)
    try:
        res = {"outcomes": run_reference_script(SCRIPT)}
        hs = [jhvd.allreduce_async(np.full((3,), float(r), np.float32),
                                   name="dup", average=False, rank=r)
              for r in range(N)]
        try:
            jhvd.allreduce_async(np.ones(3, np.float32), name="dup", rank=0)
            res["duplicate"] = None
        except jhvd.DuplicateNameError as e:
            res["duplicate"] = str(e)
        res["dup_result"] = jhvd.synchronize(hs[0])[0]
        jhvd.synchronize(hs[1])
        hs = [jhvd.allreduce_async(np.ones(2, np.float32), name="polled",
                                   rank=r) for r in range(N)]
        while not jhvd.poll(hs[0]):
            time.sleep(0.001)
        res["poll_result"] = jhvd.synchronize(hs[0])[0]
        jhvd.synchronize(hs[1])
        cache = jhvd.state().engine._response_cache
        hits0, misses0 = cache.hits, cache.misses
        for i in range(STEADY_ROUNDS):
            hs = [jhvd.allreduce_async(
                np.full((4,), float(i + j + r), np.float32), name=n,
                average=False, rank=r)
                for j, n in enumerate(STEADY) for r in range(N)]
            for h in hs:
                jhvd.synchronize(h)
        res["cache"] = (cache.hits - hits0, cache.misses - misses0)
    finally:
        jhvd.shutdown()
        mp.undo()
    res["profiler"] = path.read_text()
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("port") / "profiler.txt"
    return spawn_ranks(N, engine_session, SCRIPT, STEADY, STEADY_ROUNDS,
                       env={**PORT_ENV, "HOROVOD_PROFILER_PATH": str(path)})


def _is_error(x):
    return isinstance(x, tuple) and isinstance(x[0], str) and x[0] == "error"


def _close(got, want, name):
    got, want = _as_np(got), _as_np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if "mean" in name and np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


RESULT_NAMES = sorted(n for step in SCRIPT if step["kind"] != "mixed"
                      for n in step["items"])
ERROR_NAMES = sorted(SCRIPT[-1]["items"])


@pytest.mark.parametrize("name", RESULT_NAMES)
def test_results_match_the_reference(reference, port, name):
    for r in range(N):
        got = port[r]["outcomes"][name]
        want = reference["outcomes"][r][name]
        assert not _is_error(got), got
        if isinstance(want, tuple) or isinstance(got, tuple):
            np.testing.assert_array_equal(_as_np(got), _as_np(want))
        else:
            _close(got, want, name)


@pytest.mark.parametrize("name", ERROR_NAMES)
def test_mismatch_messages_are_the_references(reference, port, name):
    for r in range(N):
        got, want = port[r]["outcomes"][name], \
            reference["outcomes"][r][name]
        assert got[0] == "error" and want[0] == "error"
        assert got[1:] == want[1:], (got, want)


def test_duplicate_name_message_and_rollback(reference, port):
    for r in range(N):
        assert port[r]["duplicate"] == reference["duplicate"]
        assert port[r]["duplicate"].startswith(
            "Requested to allreduce, allgather, or broadcast a tensor with "
            "the same name")
        # the first submission survives the rejected second one
        np.testing.assert_array_equal(port[r]["dup_result"],
                                      reference["dup_result"])


def test_direct_allgather_takes_uneven_dim0(port):
    """ops/collectives.py ``allgather`` (the direct path): dim 0 of 2 and
    3, learned by a small all-gather first."""
    want = np.concatenate([np.full((2 + r, 3), float(r), np.float32)
                           for r in range(N)])
    for r in range(N):
        np.testing.assert_array_equal(port[r]["direct_allgather"], want)


def test_poll_then_synchronize(reference, port):
    for r in range(N):
        np.testing.assert_array_equal(port[r]["poll_result"],
                                      reference["poll_result"])


def test_response_cache_hits_match_the_reference(reference, port):
    """The steady rounds: each rank's cache misses once a name and hits
    every later round, as the reference's shared cache does."""
    for r in range(N):
        assert port[r]["cache"] == reference["cache"] == (
            len(STEADY) * (STEADY_ROUNDS - 1), len(STEADY))


def test_steady_state_takes_the_bypass(port):
    """Identical rounds after the first run coordinator-free (the
    epoch-token bypass's local replay), on every rank."""
    for r in range(N):
        assert port[r]["fast_lane_cycles"] >= STEADY_ROUNDS - 1


def _profiler_sections(text):
    """profiler.txt without the times: {op: (calls, {size: count})}."""
    out, op = {}, None
    for line in text.splitlines():
        if line.startswith("Counter "):
            op, calls = line[len("Counter "):].rsplit(",", 1)
            out[op] = (int(calls), {})
        elif line and line[0].isdigit():
            size, count = line.split(",")[:2]
            out[op][1][int(size)] = int(count)
    return out


def test_profiler_lines_match_the_reference(reference, port):
    """The counters and message sizes of every collective row. The
    reference's two ranks live in one process, whose allgather and
    alltoall rows carry both ranks' blocks (``rows.nbytes``): the port's
    rank, a process of its own, records its one block, as a
    one-rank-a-process JAX job does. ``gather``/``gatherv`` are the
    control plane's publishes and fetches, which only a job of several
    processes has."""
    got = _profiler_sections(port[0]["profiler"])
    want = _profiler_sections(reference["profiler"])
    assert list(got) == list(want)
    for op in want:
        if op in ("gather", "gatherv"):
            assert want[op][0] == 0 and got[op][0] > 0
            continue
        calls, sizes = want[op]
        if op in ("allgather", "alltoall"):
            sizes = {sz // N: c for sz, c in sizes.items()}
        assert got[op] == (calls, sizes), op
    assert got["allreduce cached"][0] > 0


def test_stall_warning_and_error_are_the_references(monkeypatch, caplog):
    env = {"HOROVOD_STALL_CHECK_TIME_SECONDS": "1",
           "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "2"}
    got = spawn_ranks(N, stall_session, env=env)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jhvd.shutdown()
    jhvd.init(num_ranks=N)
    monkeypatch.setattr(logging.getLogger("horovod_tpu"), "propagate", True)
    try:
        hs = [jhvd.allreduce_async(np.ones(2, np.float32),
                                   name="stall.both", rank=r)
              for r in range(N)]
        stalled = jhvd.allreduce_async(np.ones(2, np.float32),
                                       name="stall.x", rank=0)
        for h in hs:
            jhvd.synchronize(h)
        with caplog.at_level(logging.WARNING, logger="horovod_tpu"):
            with pytest.raises(jhvd.StalledTensorError) as err:
                jhvd.synchronize(stalled)
    finally:
        jhvd.shutdown()
    want = [rec.getMessage() for rec in caplog.records
            if "Stalled ranks:" in rec.getMessage()]
    assert want and want[0].endswith("\nStalled ranks:\n1: [stall.x]")
    assert got[0]["error"] == str(err.value)
    assert [w for w in got[0]["warnings"] if "Stalled ranks:" in w][0] \
        == want[0]
    assert got[1]["error"] is None


def test_a_peers_shutdown_fails_pending_handles_fast():
    """test_multihost_eager.py::test_multihost_graceful_shutdown_
    propagation: the peer's exit reaches the pending handle as
    ShutDownError in the reference's wording, well inside the stall
    deadline."""
    got = spawn_ranks(N, shutdown_propagation,
                      env={"HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "30"})
    message, waited = got[0]
    assert message == str(jhvd.ShutDownError())
    assert waited < 10


# ------------------------------------------------------------- one rank

@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield hvd.runtime.engine()
    hvd.shutdown()


def _round(tag, shapes, **kw):
    hs = [hvd.allreduce_async(torch.full(s, float(i + 1)), average=False,
                              name=f"{tag}.{i}", **kw)
          for i, s in enumerate(shapes)]
    return [hvd.synchronize(h) for h in hs]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_pipeline_depths_agree(monkeypatch, depth):
    """HOROVOD_PIPELINE_DEPTH changes when buckets complete, never what
    they hold (test_overlap_pipeline.py::test_pipeline_matches_sync_mode);
    at depth 0 no completion thread starts."""
    monkeypatch.setenv("HOROVOD_PIPELINE_DEPTH", str(depth))
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "256")
    hvd.init(device="cpu")
    try:
        eng = hvd.runtime.engine()
        got = _round("pipe", [(30,), (7, 3), (50,), (2,)])
        for i, t in enumerate(got):
            assert torch.equal(t, torch.full(t.shape, float(i + 1)))
        assert (eng._completion_thread is None) == (depth == 0)
    finally:
        hvd.shutdown()


def test_poll_is_never_true_while_in_flight(one_rank):
    """poll() is True only once the result landed: a launched bucket not
    yet completed polls False (test_overlap_pipeline.py::
    test_poll_never_true_while_inflight)."""
    for i in range(20):
        h = hvd.allreduce_async(torch.full((64,), float(i)), name=f"pl.{i}")
        while not hvd.poll(h):
            with one_rank._lock:
                assert isinstance(one_rank._handles[h], str)
        with one_rank._lock:
            assert not isinstance(one_rank._handles[h], str)
        assert torch.equal(hvd.synchronize(h), torch.full((64,), float(i)))


def test_shutdown_drains_inflight_handles():
    hvd.init(device="cpu")
    eng = hvd.runtime.engine()
    h = hvd.allreduce_async(torch.full((4,), 2.0), name="drain",
                            average=False)
    with eng._lock:
        eng._run_cycle()
    queued = hvd.allreduce_async(torch.ones(1), name="queued")
    eng.shutdown()
    assert torch.equal(eng.synchronize(h)[0], torch.full((4,), 2.0))
    with pytest.raises(hvd.ShutDownError):
        eng.synchronize(queued)
    hvd.shutdown()


class _GatedWork:
    """A collective's Work whose wait() first blocks until the test opens
    the gate (the engine's wait on a slow gloo transfer)."""

    def __init__(self, work, entered, gate):
        self._work, self._entered, self._gate = work, entered, gate

    def wait(self):
        self._entered.set()
        self._gate.wait(30)
        return self._work.wait()


_GATED_CALLS = {"allreduce": "all_reduce", "broadcast": "broadcast",
                "alltoall": "all_to_all_single",
                "allgather": ("all_gather_single"
                              if hasattr(torch.distributed,
                                         "all_gather_single")
                              else "all_gather_into_tensor")}


@pytest.mark.parametrize("op", sorted(_GATED_CALLS))
def test_poll_returns_while_a_collective_waits(monkeypatch, op):
    """No thread waits on a Work while it holds the engine lock: with one
    thread blocked in a gloo collective's wait (depth 0, the caller
    completes what it launched), another thread's poll() runs a cycle,
    completes its own allreduce and returns (ops/engine.py, Locking)."""
    import threading
    monkeypatch.setenv("HOROVOD_PIPELINE_DEPTH", "0")
    entered, gate = threading.Event(), threading.Event()
    real = getattr(torch.distributed, _GATED_CALLS[op])
    first = []

    def gated(*args, **kw):
        work = real(*args, **kw)
        if first:
            return work
        first.append(True)
        return _GatedWork(work, entered, gate)

    monkeypatch.setattr(torch.distributed, _GATED_CALLS[op], gated)
    hvd.init(device="cpu")
    try:
        x = torch.arange(4, dtype=torch.float32)
        out = {}
        call = {"allreduce": lambda: hvd.allreduce(x, average=False,
                                                   name="blocked"),
                "allgather": lambda: hvd.allgather(x, name="blocked"),
                "broadcast": lambda: hvd.broadcast(x, 0, name="blocked"),
                "alltoall": lambda: hvd.alltoall(x, name="blocked")}[op]
        blocked = threading.Thread(target=lambda: out.update(r=call()))
        blocked.start()
        assert entered.wait(30)
        t0 = time.perf_counter()
        h = hvd.allreduce_async(torch.full((3,), 2.0), average=False,
                                name="free")
        while not hvd.poll(h):
            assert time.perf_counter() - t0 < 10
        waited = time.perf_counter() - t0
        assert not gate.is_set() and blocked.is_alive()
        assert torch.equal(hvd.synchronize(h), torch.full((3,), 2.0))
        gate.set()
        blocked.join(30)
        assert torch.equal(out["r"], x)
        assert waited < 10
    finally:
        gate.set()
        hvd.shutdown()


def test_device_resident_results_match_the_default_path(one_rank):
    """to_host=False, the JAX package's device-resident flag, is accepted
    and takes the one result path: the values the default call gives
    (test_device_resident.py), views of one bucket on the input's
    device."""
    shapes = [(16,), (4, 4), (3,)]
    a = _round("host", shapes)
    b = _round("dev", shapes, to_host=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the three results share one bucket
    assert b[0].untyped_storage().data_ptr() == \
        b[1].untyped_storage().data_ptr()


def test_device_resident_buckets_are_not_binned(one_rank):
    """Known difference: the JAX package pads a device-resident
    (to_host=False) bucket to a power of two (one XLA program a size
    class); the port has one result path with PADDING_ALGO's exact
    sizes, so profiler.txt's message size differs."""
    stats = hvd.runtime.live_state().stats
    _round("bin", [(100,), (200,)], to_host=False)
    assert stats.histogram("allreduce") == {1200: (1, stats.histogram(
        "allreduce")[1200][1])}
    assert one_rank._fused_nelem([100, 200]) == 300
    jeng = jengine.EagerEngine.__new__(jengine.EagerEngine)
    jeng.config = type("C", (), {"padding_algo": 0,
                                 "hierarchical_allreduce": False})()
    jeng._hier_mesh = None
    assert jengine.EagerEngine._fused_nelem(jeng, [100, 200],
                                            binned=True) == 512


@pytest.mark.parametrize("padding", [0, 1])
def test_padding_algo_sizes_match_the_reference(monkeypatch, padding):
    monkeypatch.setenv("PADDING_ALGO", str(padding))
    hvd.init(device="cpu")
    try:
        _round("pad", [(100,), (200,)])
        sizes = set(hvd.runtime.live_state().stats.histogram("allreduce"))
    finally:
        hvd.shutdown()
    assert sizes == {(512 if padding else 300) * 4}


def test_wire_cache_steady_state_hit_rate(one_rank):
    for _ in range(10):
        _round("wc", [(8,), (3, 2)])
    wc = one_rank.wire_cache
    assert wc.misses == 1 and wc.hits == 9 and wc.hit_rate == 0.9


def test_an_inplace_bucket_of_one_reduces_the_tensor_itself(monkeypatch):
    """A batch of one in-place request at or above the threshold goes
    without the copy in and out: the result is the tensor."""
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "64")
    hvd.init(device="cpu")
    try:
        t = torch.arange(32.0)
        ptr = t.data_ptr()
        out = hvd.allreduce_(t, name="big")
        assert out is t and t.data_ptr() == ptr
        assert torch.equal(t, torch.arange(32.0))
        small = torch.ones(2)
        assert hvd.allreduce_(small, name="small") is small
    finally:
        hvd.shutdown()


def test_single_rank_world_is_identity(one_rank):
    x = torch.arange(5, dtype=torch.int64)
    assert torch.equal(hvd.allreduce(x, average=False, name="id"), x)
    assert torch.equal(hvd.allgather(x.view(5, 1), name="idg").view(5), x)
    assert torch.equal(hvd.broadcast(x, 0, name="idb"), x)
    assert torch.equal(hvd.alltoall(x[:4].clone(), name="ida"), x[:4])


def test_enqueue_rejects_a_rank_this_process_does_not_own(one_rank):
    with pytest.raises(ValueError, match="out of range"):
        one_rank.enqueue(pengine.ALLREDUCE, torch.ones(1), "x", rank=3)


def test_fusion_plan_native_matches_the_python_planner(one_rank):
    """The native planner (csrc/fusion.cc) against the same look-ahead
    in plain Python and the JAX engine's planner, on random sizes and
    wire dtypes; the sequential split of the pure-Python fallback where
    no later entry fits an earlier group."""
    import types
    rng = np.random.default_rng(3)

    def plain(sizes, dts, threshold, unit=64):
        align = [-(-s // unit) * unit for s in sizes]
        group, g = [-1] * len(sizes), 0
        for i in range(len(sizes)):
            if group[i] != -1:
                continue
            group[i], used = g, align[i]
            for j in range(i + 1, len(sizes)):
                if (group[j] == -1 and dts[j] == dts[i]
                        and used + align[j] <= threshold):
                    group[j], used = g, used + align[j]
            g += 1
        return group

    def entries(sizes, dts):
        return [(types.SimpleNamespace(nbytes=s, name=str(i)), False, d)
                for i, (s, d) in enumerate(zip(sizes, dts))]

    for case in range(20):
        n = int(rng.integers(2, 40))
        sizes = [int(s) for s in rng.integers(1, 3000, n)]
        dts = [str(d) for d in rng.choice(["float32", "bfloat16"], n)]
        threshold = int(rng.integers(64, 8192))
        one_rank.config.fusion_threshold = threshold
        got = one_rank._plan_fusion(entries(sizes, dts))
        groups = plain(sizes, dts, threshold)
        want = [[int(e) for e in np.flatnonzero(np.array(groups) == g)]
                for g in range(max(groups) + 1)]
        assert [[int(e.name) for e, _ in b] for b, _ in got] == want
        jeng = jengine.EagerEngine.__new__(jengine.EagerEngine)
        jeng.config = types.SimpleNamespace(fusion_threshold=threshold)
        from horovod_tpu import native as jnative
        jeng._native_lib = jnative.get_lib()
        if jeng._native_lib is not None:
            ref = jengine.EagerEngine._plan_fusion(jeng,
                                                   entries(sizes, dts))
            assert [[e.name for e, _ in b] for b, _ in ref] == \
                [[e.name for e, _ in b] for b, _ in got]
    # ascending sizes of one dtype: nothing later fits an earlier group,
    # and the fallback's sequential split is the same plan
    sizes = [100, 200, 400, 800, 1600, 3200]
    one_rank.config.fusion_threshold = 1000
    jeng = jengine.EagerEngine.__new__(jengine.EagerEngine)
    jeng.config = types.SimpleNamespace(fusion_threshold=1000)
    jeng._native_lib = None
    seq = jengine.EagerEngine._plan_fusion(
        jeng, [(types.SimpleNamespace(nbytes=s, name=str(i)), False,
                "float32") for i, s in enumerate(sizes)])
    got = one_rank._plan_fusion(entries(sizes, ["float32"] * 6))
    assert [[e.name for e, _ in b] for b, _ in seq] == \
        [[e.name for e, _ in b] for b, _ in got]


@pytest.mark.parametrize("seed", range(4))
def test_unfuse_segments_matches_the_reference(seed):
    """The port's unfuse against the JAX package's in-graph one: the
    wire dtype cast back, the float divide and integer floor divide,
    the postscale, on random segment layouts."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    dtypes = [(np.float32, torch.float32), (np.int32, torch.int32),
              (np.float64, torch.float64)]
    segs_j, segs_p, off = [], [], 0
    for _ in range(6):
        shape = tuple(int(d) for d in rng.integers(1, 4, 2))
        cnt = int(np.prod(shape))
        nd, td = dtypes[int(rng.integers(0, 3))]
        avg = bool(rng.integers(0, 2))
        post = None if rng.random() < 0.5 else 0.5
        segs_j.append((off, cnt, shape, np.dtype(nd), avg, post))
        segs_p.append((off, cnt, shape, td, avg, post))
        off += cnt
    row = rng.integers(-50, 50, off).astype(np.float32)
    with jax.enable_x64():  # as the JAX engine runs a 64-bit segment
        want = [np.asarray(w) for w in jcollectives.unfuse_segments(
            jnp.asarray(row), tuple(segs_j), 3)]
    before = torch.from_numpy(row.copy())
    t = before.clone()
    got = pcollectives.unfuse_segments(t, tuple(segs_p), 3)
    assert torch.equal(t, before)  # not in place by default
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    inplace = pcollectives.unfuse_segments(t, tuple(segs_p), 3,
                                           inplace=True)
    for g, w in zip(inplace, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wire_profile_dumps_the_size_bins(monkeypatch, tmp_path):
    """HOROVOD_WIRE_PROFILE: hvd_wire_seconds by power-of-two size bin,
    dumped to profiler.csv at shutdown in the JAX package's layout."""
    path = tmp_path / "profiler.csv"
    monkeypatch.setenv("HOROVOD_WIRE_PROFILE", "1")
    monkeypatch.setenv("HOROVOD_WIRE_PROFILE_PATH", str(path))
    hvd.init(device="cpu")
    try:
        _round("wp", [(100,), (200,)])
        hvd.allgather(torch.ones(3, 2), name="wp.g")
    finally:
        hvd.shutdown()
    rows = path.read_text().splitlines()
    assert rows[0] == "op,size_bin_bytes,count,mean_us,total_us"
    bins = {(r.split(",")[0], int(r.split(",")[1])) for r in rows[1:]}
    assert ("allreduce", 2048) in bins and ("allgather", 32) in bins


def test_hierarchical_route_sums_over_two_tiers():
    """HOROVOD_HIERARCHICAL_ALLREDUCE over 4 ranks, local size 2: the
    engine's bucket goes through ops/collectives.py's
    hierarchical_allreduce (reduce-scatter, cross all-reduce,
    all-gather); the sums are the flat ones, the bucket padded to a
    multiple of the local tier."""
    rng = np.random.default_rng(7)
    inp = [[rng.integers(-8, 9, shape).astype(np.float32)
            for _ in range(4)] for shape in ((5,), (3, 2), (6,))]
    got = spawn_ranks(4, hierarchical_session, inp,
                      env={"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                           "HOROVOD_DCN_LOCAL_SIZE": "2"})
    for r in range(4):
        assert got[r]["local"] == 2
        np.testing.assert_array_equal(got[r]["out"][0], sum(inp[0]))
        np.testing.assert_allclose(got[r]["out"][1], sum(inp[1]) / 4,
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[r]["out"][2], sum(inp[2]))
        # 17 elements, padded to 18 for the two-rank local tier
        assert got[r]["sizes"] == [(5 + 6 + 6 + 1) * 4]
