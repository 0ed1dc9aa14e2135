"""Python mirror of the native message wire format (csrc/message.{h,cc}).

Counterpart of horovod_tpu/wire.py, byte for byte.

Reference equivalent: the FlatBuffers (de)serialization in
horovod/common/message.cc + wire/message.fbs. The format here is the
length-prefixed little-endian layout defined by csrc/message.cc (magic
'HVTP', version byte) — the multi-host coordinator exchanges these blobs over
the session's key-value store. Bit-compatibility with the C++ implementation
is covered by tests/test_torch_native.py and test_torch_coordinator.py.
"""

import struct
from typing import List

from .negotiation import RequestMeta

MAGIC = b"HVTP"
VERSION = 1

# numpy dtype name -> DataType tag (csrc/message.h, value-compatible with the
# reference enum message.h:26-40 + bfloat16)
DTYPE_TAGS = {
    "uint8": 0, "int8": 1, "uint16": 2, "int16": 3, "int32": 4, "int64": 5,
    "float16": 6, "float32": 7, "float64": 8, "bool": 9, "bfloat16": 10,
}
TAG_DTYPES = {v: k for k, v in DTYPE_TAGS.items()}

OP_TAGS = {"ALLREDUCE": 0, "ALLGATHER": 1, "BROADCAST": 2, "ALLTOALL": 3,
           # Forward declaration for the reduce-scatter exchange
           # (ops/collectives.bucketed_reducescatter_allgather /
           # ZeRO-1 DistributedOptimizer). The jit path needs no
           # negotiation today; the tag reserves the value so an eager
           # reduce-scatter can ride the existing format without a
           # version bump. csrc/message.h stops at the reference's op
           # set + ALLTOALL — C++ round-trip parity is asserted over
           # those tags only (tests/test_native.py).
           "REDUCESCATTER": 4}
TAG_OPS = {v: k for k, v in OP_TAGS.items()}


def serialize_request_list(reqs: List[RequestMeta], names: List[str],
                           shutdown=False) -> bytes:
    """Layout parity: csrc/message.cc SerializeRequestList. The request's
    ``average`` flag rides in the (otherwise unused here) device field."""
    out = [MAGIC, struct.pack("<BBi", VERSION, 1 if shutdown else 0,
                              len(reqs))]
    for req, name in zip(reqs, names):
        nb = name.encode()
        out.append(struct.pack("<iiiii", req.rank, OP_TAGS[req.op],
                               DTYPE_TAGS[req.dtype], req.root_rank,
                               1 if req.average else 0))
        out.append(struct.pack("<i", len(nb)))
        out.append(nb)
        out.append(struct.pack("<i", len(req.shape)))
        for d in req.shape:
            out.append(struct.pack("<q", d))
    return b"".join(out)


def parse_request_list(blob: bytes):
    """Returns (requests, names, shutdown). Raises ValueError on bad blobs."""
    if blob[:4] != MAGIC:
        raise ValueError("bad magic")
    pos = 4
    version, shutdown, n = struct.unpack_from("<BBi", blob, pos)
    pos += 6
    if version != VERSION:
        raise ValueError(f"unsupported wire version {version}")
    reqs, names = [], []
    for _ in range(n):
        rank, op, dtype, root, device = struct.unpack_from("<iiiii", blob,
                                                           pos)
        pos += 20
        (nlen,) = struct.unpack_from("<i", blob, pos)
        pos += 4
        name = blob[pos:pos + nlen].decode()
        pos += nlen
        (ndim,) = struct.unpack_from("<i", blob, pos)
        pos += 4
        shape = struct.unpack_from(f"<{ndim}q", blob, pos) if ndim else ()
        pos += 8 * ndim
        if op not in TAG_OPS or dtype not in TAG_DTYPES:
            # the JAX package's parser lets this escape as a KeyError
            raise ValueError(f"unknown op tag {op} or dtype tag {dtype}")
        reqs.append(RequestMeta(rank=rank, op=TAG_OPS[op],
                                dtype=TAG_DTYPES[dtype],
                                shape=tuple(shape), root_rank=root,
                                average=bool(device)))
        names.append(name)
    return reqs, names, bool(shutdown)
