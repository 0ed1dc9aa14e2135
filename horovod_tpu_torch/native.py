"""ctypes loader for the native control-plane library.

Counterpart of horovod_tpu/native.py. The library carries the control
plane of the eager engine: the collective stats, the response cache,
the fusion planner and its offsets, the timeline writer and the
autotuner's Bayesian optimizer (``gaussian_process``, the ``hvd_bo_*``
entries), and, as in the JAX package, the native message format
(``hvd_request_list_serialize`` / ``_parse``, which read and write
wire.py's bytes; the coordinator serializes with wire.py) and the half
converters (``hvd_f32_to_bf16`` and friends, ``hvd_bf16_sum``; torch
casts the runtime's half types itself). Its sources are the port's own
copy, ``horovod_tpu_torch/csrc/*.cc``, of the JAX package's. At first
use they
compile with ``g++`` into one shared library in
``build/horovod_tpu_torch/``, named by a hash of every source, header
and flag, as ops/_build.py names the CUDA libraries, so an edited
source rebuilds and an unchanged one loads as it is. A failed build
raises: the pure-Python mirrors (``ResponseCache``, the sequential
fusion split, ``CollectiveStats``, ``Timeline``) are classes of their
own that a caller constructs on purpose, never a fallback.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .utils.logging import get_logger

_logger = get_logger()
_lock = threading.Lock()
_lib = None

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "horovod_tpu_torch"
# libstdc++ is linked in, its symbols kept local, and the library's own
# references bound to its own definitions: it never binds to the C++
# runtime another module of the process loaded (on the card, a library
# built against the host's g++ 13 crashed in its first std::ofstream
# inside torch's process).
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread",
             "-shared", "-static-libstdc++", "-static-libgcc",
             "-Wl,--exclude-libs,ALL", "-Wl,-Bsymbolic")


def sources():
    return sorted(CSRC.glob("*.cc"))


def library_path():
    """Where the library for the current sources, headers and flags
    lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cc")) + sorted(CSRC.glob("*.h")):
        digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"libhvd_control-{digest.hexdigest()[:16]}.so"


def build():
    """Compile the library unless it is there; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # One build at a time across processes (parallel test workers): the
    # first builds, the rest find its library when the lock frees.
    with open(BUILD_DIR / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        return _compile(out)


def _compile(out):
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(
            "no C++ compiler (g++) found: the native control plane "
            "(horovod_tpu_torch/csrc) is built from source at first use")
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                           *map(str, sources())],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native control-plane build failed "
                           f"({cxx} exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    _logger.info("built %s", out.name)
    return out


def _declare(lib):
    c = ctypes
    lib.hvd_stats_new.restype = c.c_void_p
    lib.hvd_stats_free.argtypes = [c.c_void_p]
    lib.hvd_stats_record.argtypes = [c.c_void_p, c.c_char_p, c.c_int64,
                                     c.c_int64]
    lib.hvd_stats_counter.argtypes = [c.c_void_p, c.c_char_p]
    lib.hvd_stats_counter.restype = c.c_int64
    lib.hvd_stats_total_time_us.argtypes = [c.c_void_p, c.c_char_p]
    lib.hvd_stats_total_time_us.restype = c.c_int64
    lib.hvd_stats_write_file.argtypes = [c.c_void_p, c.c_char_p]
    lib.hvd_stats_write_file.restype = c.c_int
    lib.hvd_stats_histogram.argtypes = [c.c_void_p, c.c_char_p,
                                        c.POINTER(c.c_int64),
                                        c.POINTER(c.c_int64),
                                        c.POINTER(c.c_int64), c.c_int]
    lib.hvd_stats_histogram.restype = c.c_int

    lib.hvd_cache_new.argtypes = [c.c_int]
    lib.hvd_cache_new.restype = c.c_void_p
    lib.hvd_cache_free.argtypes = [c.c_void_p]
    lib.hvd_cache_lookup.argtypes = [c.c_void_p, c.c_char_p]
    lib.hvd_cache_lookup.restype = c.c_int
    lib.hvd_cache_put.argtypes = [c.c_void_p, c.c_char_p]
    lib.hvd_cache_remove.argtypes = [c.c_void_p, c.c_char_p]
    for fn in (lib.hvd_cache_hits, lib.hvd_cache_misses, lib.hvd_cache_size):
        fn.argtypes = [c.c_void_p]
        fn.restype = c.c_int64

    lib.hvd_fusion_plan.argtypes = [
        c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.c_int, c.c_int64,
        c.POINTER(c.c_int32)]
    lib.hvd_fusion_plan.restype = c.c_int
    lib.hvd_fusion_offsets.argtypes = [c.POINTER(c.c_int64), c.c_int,
                                       c.POINTER(c.c_int64)]
    lib.hvd_fusion_offsets.restype = c.c_int64

    lib.hvd_timeline_new.argtypes = [c.c_char_p, c.c_int]
    lib.hvd_timeline_new.restype = c.c_void_p
    lib.hvd_timeline_event.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p,
                                       c.c_char, c.c_int64, c.c_int]
    lib.hvd_timeline_cycle.argtypes = [c.c_void_p, c.c_int64]
    lib.hvd_timeline_close.argtypes = [c.c_void_p]
    lib.hvd_timeline_counter.argtypes = [c.c_void_p, c.c_char_p, c.c_int64,
                                         c.c_double]

    lib.hvd_bo_new.argtypes = [c.c_int, c.POINTER(c.c_double),
                               c.POINTER(c.c_double), c.c_double,
                               c.c_uint64]
    lib.hvd_bo_new.restype = c.c_void_p
    lib.hvd_bo_free.argtypes = [c.c_void_p]
    lib.hvd_bo_add_sample.argtypes = [c.c_void_p, c.POINTER(c.c_double),
                                      c.c_int, c.c_double]
    lib.hvd_bo_suggest.argtypes = [c.c_void_p, c.POINTER(c.c_double),
                                   c.c_int]

    i32 = c.POINTER(c.c_int32)
    lib.hvd_request_list_serialize.argtypes = [
        c.c_int, i32, i32, i32, i32, i32, c.POINTER(c.c_char_p), i32,
        c.POINTER(c.c_int64), c.c_int, c.c_char_p, c.c_int64]
    lib.hvd_request_list_serialize.restype = c.c_int64
    lib.hvd_request_list_parse.argtypes = [
        c.c_char_p, c.c_int64, c.c_int, c.c_int64, i32, i32, i32, i32, i32,
        i32, c.POINTER(c.c_int64), c.c_char_p, c.c_int64,
        c.POINTER(c.c_int)]
    lib.hvd_request_list_parse.restype = c.c_int

    for fn in (lib.hvd_f32_to_bf16, lib.hvd_f32_to_f16):
        fn.argtypes = [c.POINTER(c.c_float), c.POINTER(c.c_uint16), c.c_int64]
    for fn in (lib.hvd_bf16_to_f32, lib.hvd_f16_to_f32):
        fn.argtypes = [c.POINTER(c.c_uint16), c.POINTER(c.c_float), c.c_int64]
    lib.hvd_bf16_sum.argtypes = [c.POINTER(c.c_uint16),
                                 c.POINTER(c.c_uint16),
                                 c.POINTER(c.c_uint16), c.c_int64]
    return lib


def get_lib():
    """The native library, built first if stale. Raises when it cannot
    be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib
