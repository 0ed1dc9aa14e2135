"""Stress coverage of the port: the wire codec under a seeded fuzz and
corrupt blobs, and the eager engine under concurrent submitter threads.

Counterpart of tests/test_stress.py. The fuzz's 200 request lists are
serialized by the port's wire.py and by the JAX package's, byte for
byte, and parse back whole; a corrupt magic, version or dtype tag is
refused with ValueError. The engine's lock is driven by many threads of
each of two gloo ranks (one spawn for the module, with divergent
per-rank values): synchronous allreduces from 32 threads at once, and
handles made by one thread synchronized by another.
"""

import random
import struct

import numpy as np
import pytest

from horovod_tpu import wire as jwire
from horovod_tpu.negotiation import RequestMeta as JRequestMeta
from horovod_tpu_torch import wire
from horovod_tpu_torch.negotiation import RequestMeta
from torch_engine_workers import stress_session
from torch_ranks import spawn_ranks

N = 2
THREADS, PER_THREAD = 32, 8
ASYNC, DRAIN = 16, 8


def _fuzz_case(rng, trial):
    """One random request list (every op, dtype and shape rank), as
    tests/test_stress.py draws it."""
    n = rng.randrange(0, 6)
    reqs, names = [], []
    for i in range(n):
        shape = tuple(rng.randrange(0, 17)
                      for _ in range(rng.randrange(0, 5)))
        reqs.append(dict(
            rank=rng.randrange(0, 1024),
            op=rng.choice(list(wire.OP_TAGS)),
            dtype=rng.choice(list(wire.DTYPE_TAGS)),
            shape=shape,
            root_rank=rng.randrange(0, 64),
            average=bool(rng.getrandbits(1))))
        # names include unicode and separators the codec must carry
        names.append(f"t/{trial}.{i}-é{'x' * rng.randrange(0, 40)}")
    return reqs, names, bool(rng.getrandbits(1))


def test_wire_roundtrip_fuzz_is_byte_equal_to_the_reference():
    """200 seeded request lists: the port's blob is the JAX package's,
    byte for byte, and parses back to the same requests, names and
    shutdown flag."""
    assert wire.DTYPE_TAGS == jwire.DTYPE_TAGS
    assert wire.OP_TAGS == jwire.OP_TAGS
    rng = random.Random(0xC0FFEE)
    for trial in range(200):
        reqs, names, shutdown = _fuzz_case(rng, trial)
        blob = wire.serialize_request_list(
            [RequestMeta(**r) for r in reqs], names, shutdown=shutdown)
        assert blob == jwire.serialize_request_list(
            [JRequestMeta(**r) for r in reqs], names, shutdown=shutdown)
        reqs2, names2, shutdown2 = wire.parse_request_list(blob)
        assert shutdown2 == shutdown and names2 == names
        assert [(b.rank, b.op, b.dtype, tuple(b.shape), b.root_rank,
                 b.average) for b in reqs2] == [
            (a["rank"], a["op"], a["dtype"], a["shape"], a["root_rank"],
             a["average"]) for a in reqs]


def _blob():
    return wire.serialize_request_list(
        [RequestMeta(rank=0, op="ALLREDUCE", dtype="float32", shape=(2,),
                     root_rank=0, average=True)], ["n"])


@pytest.mark.parametrize("where", ["magic", "version", "dtype_tag",
                                   "op_tag"])
def test_wire_rejects_corruption(where):
    """A corrupt magic or version byte (tests/test_stress.py's two
    blobs), and an unknown dtype or op tag in a request, which the JAX
    package's parser lets escape as a KeyError: ValueError each."""
    blob = _blob()
    request = 4 + 6  # magic, then version, shutdown and count
    if where == "magic":
        bad = b"XXXX" + blob[4:]
    elif where == "version":
        bad = blob[:4] + bytes([99]) + blob[5:]
    else:
        at = request + (8 if where == "dtype_tag" else 4)
        bad = blob[:at] + struct.pack("<i", 99) + blob[at + 4:]
    with pytest.raises(ValueError):
        wire.parse_request_list(bad)


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(N, stress_session, THREADS, PER_THREAD, ASYNC, DRAIN,
                       timeout=180)


def test_engine_concurrent_submitters(ranks):
    """32 threads x 8 ops a rank, all distinct names, submitted at once:
    every result is the exact sum over the ranks; no handle is lost or
    crossed."""
    total = sum(r + 1 for r in range(N))
    for r in range(N):
        assert not ranks[r]["errors"], ranks[r]["errors"][:3]
        got = ranks[r]["sync"]
        assert len(got) == THREADS * PER_THREAD
        for (t, i), out in got.items():
            np.testing.assert_array_equal(
                out, np.full((4,), float(t * 100 + i) * total, np.float32),
                err_msg=f"rank {r}, thread {t}, op {i}")


def test_engine_concurrent_async_then_sync(ranks):
    """Handles made by 16 threads, synchronized by 8 others."""
    total = sum(r + 1 for r in range(N))
    for r in range(N):
        got = ranks[r]["async"]
        assert sorted(got) == list(range(ASYNC))
        for t, out in got.items():
            np.testing.assert_array_equal(
                out, np.full((3,), float(t) * total, np.float32))
