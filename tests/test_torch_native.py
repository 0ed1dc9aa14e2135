"""The port's native control plane (horovod_tpu_torch/csrc, built with
g++ at first use by horovod_tpu_torch/native.py) against the JAX
package's components.

The native stats, response cache, fusion planner and timeline writer
are held to the pure-Python mirrors (the port's and the JAX package's:
``CollectiveStats``, ``ResponseCache``, ``Timeline``) on the same random
operations. The native message format reads and writes the bytes both
packages' wire.py write; the half converters are torch's
round-to-nearest-even casts on finite values (the port's fp16 cast
repairs two faults of the JAX package's copy), and where they are not
(NaN payloads) the difference is pinned. The
port's metric registry has every family of the JAX package's, and the
device-resident bucket counter counts fused buckets. The build: named
by a hash of the
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
from horovod_tpu import metrics as jmetrics
from horovod_tpu import negotiation as jnegotiation
from horovod_tpu import stats as jstats
from horovod_tpu import wire as jwire
from horovod_tpu import timeline as jtimeline
from horovod_tpu.ops import engine as jengine
from horovod_tpu_torch import metrics, native, negotiation
from horovod_tpu_torch import stats as pstats
from horovod_tpu_torch import wire
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


# ------------------------------------------------------------ fusion offsets

def test_native_fusion_offsets_alignment(lib):
    """Offsets align to FUSION_BUFFER_ATOMIC_UNIT=64 (operations.h:30)."""
    nbytes = (ctypes.c_int64 * 3)(1, 65, 128)
    offsets = (ctypes.c_int64 * 3)()
    total = lib.hvd_fusion_offsets(nbytes, 3, offsets)
    assert list(offsets) == [0, 64, 192]
    assert total == 320


@pytest.mark.parametrize("seed", range(3))
def test_native_fusion_offsets_are_the_aligned_prefix_sums(lib, seed):
    sizes = np.random.default_rng(seed).integers(1, 5000, 40)
    nbytes = (ctypes.c_int64 * 40)(*sizes.tolist())
    offsets = (ctypes.c_int64 * 40)()
    total = lib.hvd_fusion_offsets(nbytes, 40, offsets)
    aligned = -(-sizes // 64) * 64
    assert list(offsets) == [0] + np.cumsum(aligned)[:-1].tolist()
    assert total == int(aligned.sum())


# ------------------------------------------------------ the message format

_OPS = ("ALLREDUCE", "ALLGATHER", "BROADCAST", "ALLTOALL")


def _native_serialize(lib, reqs, names, shutdown=False):
    """The native serializer over the fields wire.py packs: the average
    flag rides in the device field."""
    n = len(reqs)
    i32 = ctypes.c_int32 * max(n, 1)
    dims = [d for r in reqs for d in r.shape]
    args = (n, i32(*[r.rank for r in reqs]),
            i32(*[wire.OP_TAGS[r.op] for r in reqs]),
            i32(*[wire.DTYPE_TAGS[r.dtype] for r in reqs]),
            i32(*[r.root_rank for r in reqs]),
            i32(*[int(r.average) for r in reqs]),
            (ctypes.c_char_p * max(n, 1))(*[x.encode() for x in names]),
            i32(*[len(r.shape) for r in reqs]),
            (ctypes.c_int64 * max(len(dims), 1))(*dims), int(shutdown))
    size = lib.hvd_request_list_serialize(*args, None, 0)
    blob = ctypes.create_string_buffer(size)
    assert lib.hvd_request_list_serialize(*args, blob, size) == size
    return blob.raw


def _native_parse(lib, blob, cap=64, dims_cap=256, names_cap=8192):
    """(requests as port RequestMetas, names, shutdown), or the parser's
    negative code."""
    i32 = ctypes.c_int32 * cap
    ranks, ops, dtypes, roots, devices, ndims = (i32() for _ in range(6))
    dims = (ctypes.c_int64 * dims_cap)()
    names = ctypes.create_string_buffer(names_cap)
    shutdown = ctypes.c_int()
    n = lib.hvd_request_list_parse(blob, len(blob), cap, dims_cap, ranks,
                                   ops, dtypes, roots, devices, ndims, dims,
                                   names, names_cap, ctypes.byref(shutdown))
    if n < 0:
        return n
    reqs, pos = [], 0
    for i in range(n):
        shape = tuple(dims[pos:pos + ndims[i]])
        pos += ndims[i]
        reqs.append(negotiation.RequestMeta(
            rank=ranks[i], op=wire.TAG_OPS[ops[i]],
            dtype=wire.TAG_DTYPES[dtypes[i]], shape=shape,
            root_rank=roots[i], average=bool(devices[i])))
    out_names = [x.decode() for x in names.raw.split(b"\x00")[:n]]
    return reqs, out_names, bool(shutdown.value)


def test_native_message_roundtrip(lib):
    reqs = [negotiation.RequestMeta(0, "ALLREDUCE", "float32", (32, 64),
                                    -1, False),
            negotiation.RequestMeta(1, "BROADCAST", "bfloat16", (128,), 3,
                                    True)]
    names = ["grad/conv1", "grad/fc"]
    blob = _native_serialize(lib, reqs, names)
    assert _native_parse(lib, blob) == (reqs, names, False)


def test_native_message_rejects_garbage(lib):
    assert _native_parse(lib, b"NOTAMESSAGE") < 0


def _random_requests(rng, n):
    reqs, names = [], []
    dtypes = sorted(wire.DTYPE_TAGS)
    for i in range(n):
        shape = tuple(int(d) for d in rng.integers(
            0, 1 << int(rng.integers(1, 40)), int(rng.integers(0, 5))))
        reqs.append(dict(rank=int(rng.integers(0, 64)),
                         op=_OPS[int(rng.integers(0, 4))],
                         dtype=dtypes[int(rng.integers(0, len(dtypes)))],
                         shape=shape, root_rank=int(rng.integers(-1, 8)),
                         average=bool(rng.integers(0, 2))))
        letters = rng.choice(list("abcxyz/|._-0123456789é"),
                             int(rng.integers(1, 40)))
        names.append(f"{i}|" + "".join(letters))
    return reqs, names


@pytest.mark.parametrize("seed", range(4))
def test_wire_matches_native_format(lib, seed):
    """The same seeded requests serialize to the same bytes through the
    JAX package's wire.py, the port's and the native serializer, and
    the port's native parser reads them back field for field
    (reference: tests/test_multihost_eager.py::
    test_wire_matches_native_format)."""
    rng = np.random.default_rng(seed)
    fields, names = _random_requests(rng, int(rng.integers(0, 12)))
    shutdown = bool(seed % 2)
    ours = [negotiation.RequestMeta(**f) for f in fields]
    theirs = [jnegotiation.RequestMeta(**f) for f in fields]
    blob = wire.serialize_request_list(ours, names, shutdown)
    assert blob == jwire.serialize_request_list(theirs, names, shutdown)
    assert blob == _native_serialize(lib, ours, names, shutdown)
    assert _native_parse(lib, blob) == (ours, names, shutdown)
    assert wire.parse_request_list(blob) == (ours, names, shutdown)


# ------------------------------------------------------- the half converters

def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f32_to_16(lib, fn, x):
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.uint16)
    fn(_ptr(x, ctypes.c_float), _ptr(out, ctypes.c_uint16), x.size)
    return out


def _16_to_f32(lib, fn, h):
    h = np.ascontiguousarray(h, np.uint16)
    out = np.empty(h.shape, np.float32)
    fn(_ptr(h, ctypes.c_uint16), _ptr(out, ctypes.c_float), h.size)
    return out


def _torch_bits16(x, dtype):
    """torch's round-to-nearest-even cast of f32 ``x`` to ``dtype``, as
    its 16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dtype)
    return t.view(torch.int16).numpy().view(np.uint16)


def _finite_f32(seed, lo, hi):
    """Finite f32 values across the exponent range [2^lo, 2^hi), both
    signs, plus their neighbours at the cast's ties: every low-16-bit
    pattern 0x7FFF, 0x8000 and 0x8001 (bf16's tie) and 13-bit ones
    (fp16's)."""
    rng = np.random.default_rng(seed)
    mag = 2.0 ** rng.uniform(lo, hi, 20000)
    x = (mag * rng.choice([-1.0, 1.0], mag.size)).astype(np.float32)
    bits = x.view(np.uint32)
    ties = [(bits & ~np.uint32(0xFFFF)) | np.uint32(t)
            for t in (0x7FFF, 0x8000, 0x8001)]
    ties += [(bits & ~np.uint32(0x1FFF)) | np.uint32(t)
             for t in (0x0FFF, 0x1000, 0x1001)]
    out = np.concatenate([x] + [t.view(np.float32) for t in ties])
    return out[np.isfinite(out)]


def test_f32_to_bf16_is_torchs_cast_on_finite_values(lib):
    x = _finite_f32(0, -149, 128)
    x = np.concatenate([x, np.float32([0.0, -0.0, np.finfo(np.float32).max,
                                       np.finfo(np.float32).tiny])])
    np.testing.assert_array_equal(_f32_to_16(lib, lib.hvd_f32_to_bf16, x),
                                  _torch_bits16(x, torch.bfloat16))


def test_bf16_to_f32_is_torchs_on_every_pattern(lib):
    """Every one of the 65536 bf16 patterns, NaNs included, widens to
    the f32 torch gives, bit for bit."""
    h = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    ours = _16_to_f32(lib, lib.hvd_bf16_to_f32, h).view(np.uint32)
    want = torch.from_numpy(h.view(np.int16)).view(torch.bfloat16).float()
    np.testing.assert_array_equal(ours, want.numpy().view(np.uint32))


def test_f32_to_f16_is_torchs_cast_on_finite_values(lib):
    """Subnormal ties and values past fp16's range included: the two
    places where the JAX package's copy parts from the cast
    (test_the_fp16_cast_repairs_two_faults_of_the_reference)."""
    x = _finite_f32(1, -30, 17)
    x = np.concatenate([x, np.float32([1, 3, 5, 9]) * np.float32(2.0 ** -25),
                        np.float32([65504, 65519.99, 65520, 1e30, -7e4])])
    np.testing.assert_array_equal(_f32_to_16(lib, lib.hvd_f32_to_f16, x),
                                  _torch_bits16(x, torch.float16))


def test_f16_to_f32_is_torchs_on_every_non_nan_pattern(lib):
    h = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    ours = _16_to_f32(lib, lib.hvd_f16_to_f32, h)
    want = torch.from_numpy(h.view(np.int16)).view(torch.float16).float()
    want = want.numpy()
    nan = np.isnan(want)
    assert nan.sum() == 2 * 1023
    np.testing.assert_array_equal(ours.view(np.uint32)[~nan],
                                  want.view(np.uint32)[~nan])
    assert np.isnan(ours[nan]).all()


def test_pinned_differences_from_torchs_casts(lib):
    """Where the converters and torch's casts part, named: f32 -> bf16
    keeps a quiet NaN's top 16 bits (torch may canonicalize a NaN: on
    this CPU every one becomes 0xFFFF) and adds the rounding bias to a
    NaN too, so a NaN whose payload lies only in the low 16 bits becomes
    an infinity and the all-ones NaN wraps to +0.0, where torch keeps a
    NaN. Infinities agree, and the fp16 cast's NaN is torch's."""
    bits = np.uint32([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                      0x7F800001, 0xFFFFFFFF])
    x = bits.view(np.float32)
    ours = _f32_to_16(lib, lib.hvd_f32_to_bf16, x)
    assert ours.tolist() == [0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F80, 0x0000]
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.isinf(want[:2]).all() and np.isnan(want[2:]).all()
    assert (ours[:2] == _torch_bits16(x[:2], torch.bfloat16)).all()
    special = np.float32([np.inf, -np.inf, np.nan])
    assert _f32_to_16(lib, lib.hvd_f32_to_f16, special).tolist() == \
        _torch_bits16(special, torch.float16).tolist()


_REF_SHIM = """
#include <cstdint>
#include "half.h"
extern "C" void ref_f32_to_f16(const float* s, uint16_t* d, int64_t n) {
  hvdtpu::Float32ToFloat16(s, d, n);
}
"""


def test_the_fp16_cast_repairs_two_faults_of_the_reference(lib, tmp_path):
    """The JAX package's csrc/half.cc, built here alone, makes a finite
    value past fp16's range a NaN and rounds a subnormal tie half up;
    the port's copy gives torch's infinity and even neighbour."""
    import shutil
    import subprocess
    from pathlib import Path
    ref = Path(__file__).resolve().parents[1] / "csrc"
    (tmp_path / "shim.cc").write_text(_REF_SHIM)
    so = tmp_path / "libref_half.so"
    subprocess.run([shutil.which("g++") or "c++", "-O2", "-fPIC", "-shared",
                    "-std=c++17", f"-I{ref}", str(tmp_path / "shim.cc"),
                    str(ref / "half.cc"), "-o", str(so)], check=True,
                   capture_output=True, timeout=120)
    ref_lib = ctypes.CDLL(str(so))
    ref_lib.ref_f32_to_f16.argtypes = [ctypes.POINTER(ctypes.c_float),
                                       ctypes.POINTER(ctypes.c_uint16),
                                       ctypes.c_int64]
    x = np.float32([7e4, -1e30, 2.0 ** -25, 5 * 2.0 ** -25])
    theirs = _f32_to_16(ref_lib, ref_lib.ref_f32_to_f16, x)
    ours = _f32_to_16(lib, lib.hvd_f32_to_f16, x)
    assert theirs.tolist() == [0x7E00, 0xFE00, 1, 3]
    assert ours.tolist() == [0x7C00, 0xFC00, 0, 2]
    assert ours.tolist() == _torch_bits16(x, torch.float16).tolist()


def test_bf16_sum_is_torchs_sum(lib):
    rng = np.random.default_rng(2)
    a = _torch_bits16(rng.standard_normal(5000) * 100, torch.bfloat16)
    b = _torch_bits16(rng.standard_normal(5000), torch.bfloat16)
    out = np.empty(5000, np.uint16)
    lib.hvd_bf16_sum(_ptr(a, ctypes.c_uint16), _ptr(b, ctypes.c_uint16),
                     _ptr(out, ctypes.c_uint16), 5000)

    def bf16(h):
        return torch.from_numpy(h.view(np.int16)).view(torch.bfloat16)
    want = (bf16(a).float() + bf16(b).float()).to(torch.bfloat16)
    np.testing.assert_array_equal(out, want.view(torch.int16).numpy()
                                  .view(np.uint16))


# ------------------------------------------------------------ metric families

def test_the_registry_has_every_family_of_the_reference():
    """A family the reference registers and the port forgets fails here,
    as a forgotten knob fails test_torch_config.py: the same names,
    kinds and labels (help texts may name the port's own modules)."""
    ours = metrics.registry()._families
    theirs = jmetrics.registry()._families
    assert sorted(set(theirs) - set(ours)) == []
    for name, fam in theirs.items():
        mine = ours[name]
        assert (mine.kind, mine.labelnames) == (fam.kind, fam.labelnames), \
            name
    new = "hvd_engine_device_resident_buckets_total"
    assert ours[new].help == theirs[new].help
    assert metrics.ENGINE_DEVICE_BUCKETS is ours[new]


def _device_buckets():
    snap = hvd.metrics_snapshot()
    return snap["hvd_engine_device_resident_buckets_total"]["values"].get(
        "", 0.0)


def test_device_resident_buckets_count_fused_buckets(monkeypatch):
    """One eager step: every gradient of a small model through
    ``allreduce_async_``, under a fusion threshold that splits them; the
    counter rises once for each fused all-reduce the step launched."""
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1024")
    hvd.init(device="cpu")
    try:
        stats = hvd.runtime.live_state().stats
        model = torch.nn.Sequential(torch.nn.Linear(8, 16),
                                    torch.nn.Linear(16, 8),
                                    torch.nn.Linear(8, 2))
        model(torch.randn(4, 8)).sum().backward()
        before = _device_buckets()
        fused = stats.counter("allreduce") + stats.counter(
            "allreduce_cached")
        hs = [hvd.allreduce_async_(p.grad, name=f"g.{n}")
              for n, p in model.named_parameters()]
        for h in hs:
            hvd.synchronize(h)
        fused = stats.counter("allreduce") + stats.counter(
            "allreduce_cached") - fused
    finally:
        hvd.shutdown()
    assert fused >= 2
    assert _device_buckets() - before == fused
