"""The port's native control plane (horovod_tpu_torch/csrc, built with
g++ at first use by horovod_tpu_torch/native.py) against the JAX
package's components.

The native stats, response cache, fusion planner and timeline writer
are held to the pure-Python mirrors (the port's and the JAX package's:
``CollectiveStats``, ``ResponseCache``, ``Timeline``) on the same random
operations. The build: named by a hash of the
sources, a broken source raises with the compiler's output, and
``init()`` raises before joining any group when the library cannot be
built — nothing falls back to a mirror.

Behavioral spec: tests/test_native.py.
"""

import ctypes
import json
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu import stats as jstats
from horovod_tpu import timeline as jtimeline
from horovod_tpu.ops import engine as jengine
from horovod_tpu_torch import native, stats as pstats
from horovod_tpu_torch import timeline as ptimeline
from horovod_tpu_torch.ops import engine as pengine


@pytest.fixture(scope="module")
def lib():
    return native.get_lib()


def test_the_engine_uses_the_native_backends():
    hvd.init(device="cpu")
    try:
        eng = hvd.runtime.engine()
        assert type(eng.response_cache).__name__ == "NativeResponseCache"
        assert type(hvd.runtime.live_state().stats).__name__ == \
            "NativeCollectiveStats"
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("seed", range(3))
def test_native_stats_dump_the_mirrors_text(lib, tmp_path, seed):
    """The same records into the native registry, the port's Python
    mirror and the JAX package's: one dump, byte for byte."""
    rng = np.random.default_rng(seed)
    regs = [pstats.NativeCollectiveStats(lib), pstats.CollectiveStats(),
            jstats.CollectiveStats()]
    ops = list(pstats.CollectiveStats.OPS)
    for _ in range(200):
        op = ops[int(rng.integers(0, len(ops)))]
        nbytes = int(rng.choice([8, 64, 1024, 4096, 65536]))
        us = int(rng.integers(0, 5000))
        for reg in regs:
            reg.record(op, nbytes, us / 1e6)
    texts = []
    for i, reg in enumerate(regs):
        path = tmp_path / f"p{i}.txt"
        reg.write_to_file(str(path))
        texts.append(path.read_text())
    assert texts[0] == texts[1] == texts[2]
    for op in ops:
        assert regs[0].counter(op) == regs[2].counter(op)
        assert regs[0].histogram(op) == regs[2].histogram(op)


def test_native_stats_fold_card_events_like_the_mirror(lib):
    """NativeCollectiveStats keeps the mirror's queue of timed executions
    (stats.py): a record through ``record_events`` counts once resolved."""
    class _Ev:
        def __init__(self, t):
            self.t = t

        def query(self):
            return True

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    reg = pstats.NativeCollectiveStats(lib)
    seen = []
    reg.record_events("allreduce", 256, _Ev(0.0), _Ev(0.25), seen.append)
    assert reg.counter("allreduce") == 1
    assert reg.histogram("allreduce") == {256: (1, 250000)}
    assert seen == [0.25]
    reg.record("allgather_jit", 32, 0.0)
    assert reg.jit_records() == {("allgather_jit", 32): 1}


def _req(name, shape):
    return types.SimpleNamespace(op="ALLREDUCE", name=name, root_rank=-1,
                                 average=True,
                                 tensor=torch.zeros(shape))


def _jreq(name, shape):
    return types.SimpleNamespace(op="ALLREDUCE", name=name, root_rank=-1,
                                 average=True,
                                 tensor=np.zeros(shape, np.float32))


@pytest.mark.parametrize("capacity", [0, 2, 5])
def test_native_cache_matches_the_mirrors(lib, capacity):
    """LRU hits, misses and invalidations on random operations: the
    native cache, the port's mirror and the JAX package's mirror."""
    rng = np.random.default_rng(capacity)
    caches = [pengine.NativeResponseCache(lib, capacity),
              pengine.ResponseCache(capacity),
              jengine.ResponseCache(capacity)]
    for _ in range(300):
        name = f"t{int(rng.integers(0, 6))}"
        shape = (int(rng.integers(1, 3)),)
        what = int(rng.integers(0, 10))
        got = []
        for c in caches:
            r = (_jreq if isinstance(c, jengine.ResponseCache)
                 else _req)(name, shape)
            if what < 5:
                got.append(c.lookup(r))
            elif what < 9:
                got.append(c.put(r))
            else:
                got.append(c.invalidate_name(name))
        assert got[0] == got[1] == got[2]
    assert caches[0].hits == caches[1].hits == caches[2].hits
    assert caches[0].misses == caches[1].misses


def _plan(lib, nbytes, dts, threshold):
    n = len(nbytes)
    groups = (ctypes.c_int32 * n)()
    ng = lib.hvd_fusion_plan((ctypes.c_int64 * n)(*nbytes),
                             (ctypes.c_int32 * n)(*dts), n, threshold,
                             groups)
    return ng, list(groups)


def test_native_fusion_plan_lookahead(lib):
    """Same-dtype entries separated by another dtype still fuse
    (operations.cc:648-700)."""
    ng, groups = _plan(lib, [100, 200, 100, 100], [0, 1, 0, 0], 1 << 20)
    assert ng == 2 and groups[0] == groups[2] == groups[3] != groups[1]


def test_native_fusion_plan_threshold_split(lib):
    ng, groups = _plan(lib, [600, 600, 600], [0, 0, 0], 1280)
    assert ng == 2 and groups[0] == groups[1] != groups[2]


def test_exactly_threshold_tensors_go_alone(lib):
    """The split rule is ``batch_bytes + nbytes > threshold``: a tensor of
    exactly the threshold fills a bucket by itself (the flagship's
    64 MiB w1/w2 at the default threshold)."""
    t = 64 * 1024 * 1024
    ng, groups = _plan(lib, [t, 8192, t, t, 4096], [0] * 5, t)
    assert ng == 4 and groups == [0, 1, 2, 3, 1]


def _events(path):
    return [e for e in json.loads(path.read_text()) if e]


def test_native_timeline_matches_the_python_writers(lib, tmp_path):
    """One state sequence through the native writer, the port's Python
    writer and the JAX package's: the same events in the same order
    (names, phases, rows, threads; the timestamps are each writer's)."""
    seq = [("negotiate_start", "grad.w", "ALLREDUCE"),
           ("negotiate_end", "grad.w"),
           ("start", "grad.w", "ALLREDUCE"),
           ("activity_start", "grad.w", "MEMCPY_IN_FUSION_BUFFER"),
           ("activity_end", "grad.w"),
           ("negotiate_start", "grad.b", "ALLGATHER"),
           ("mark_cycle_start",),
           ("activity_start", "grad.w", "XLA_ALLREDUCE"),
           ("activity_end", "grad.w"),
           ("end", "grad.w"),
           ("negotiate_end", "grad.b")]
    writers = [ptimeline.NativeTimeline(lib, tmp_path / "n.json", True),
               ptimeline.Timeline(tmp_path / "p.json", enabled=True,
                                  mark_cycles=True),
               jtimeline.Timeline(tmp_path / "j.json", enabled=True,
                                  mark_cycles=True)]
    for w in writers:
        for call, *args in seq:
            getattr(w, call)(*args)
        w.close()

    def shape(path):
        return [(e.get("ph"), e.get("name"), e.get("pid"), e.get("tid"),
                 e.get("args")) for e in _events(path)]
    got = shape(tmp_path / "n.json")
    assert got == shape(tmp_path / "p.json") == shape(tmp_path / "j.json")
    assert ("i", "CYCLE_START", 0, 0, None) in got


def test_the_library_is_named_by_its_sources(tmp_path, monkeypatch):
    """An edited source names another library; a broken one raises with
    the compiler's output, and nothing is left behind."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "ok.cc").write_text('extern "C" int hvd_probe() { return 7; }\n')
    monkeypatch.setattr(native, "CSRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    first = native.library_path()
    assert native.build() == first and first.exists()
    assert ctypes.CDLL(str(first)).hvd_probe() == 7
    (src / "ok.cc").write_text('extern "C" int hvd_probe() { return 8 }\n')
    assert native.library_path() != first
    with pytest.raises(RuntimeError, match="native control-plane build "
                                           "failed"):
        native.build()
    assert not native.library_path().exists()


def test_init_raises_when_the_library_cannot_be_built(monkeypatch):
    """No silent fallback: a failed build stops ``init()`` before it
    joins a group."""
    def broken():
        raise RuntimeError("native control-plane build failed (probe)")
    monkeypatch.setattr(native, "get_lib", broken)
    with pytest.raises(RuntimeError, match="probe"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized() and not dist.is_initialized()


def test_the_library_carries_its_own_cxx_runtime(lib):
    """libstdc++ is linked in with its symbols local and the library's
    references bound to itself: inside torch's process on the card, a
    build that took the shared C++ runtime crashed in its first
    std::ofstream (the profiler.txt dump)."""
    import shutil
    import subprocess
    readelf = shutil.which("readelf")
    if readelf is None:
        pytest.skip("no readelf")
    dyn = subprocess.run([readelf, "-d", str(native.library_path())],
                         capture_output=True, text=True, check=True).stdout
    needed = [line for line in dyn.splitlines() if "(NEEDED)" in line]
    assert needed and not any("libstdc++" in n or "libgcc_s" in n
                              for n in needed), needed
    assert "SYMBOLIC" in dyn
