"""Cross-rank request validation — the coordinator's decision logic.

Counterpart of horovod_tpu/negotiation.py, word for word.

Reference equivalent: ``ConstructResponse``
(horovod/common/operations.cc:325-527): given every rank's Request for a
named tensor, either produce an executable response (op type, per-rank
allgather sizes) or an error message describing the first inconsistency, with
exact message wording. Shared by the in-process engine (ops/engine.py) and
the multi-host coordinator (coordinator.py).
"""

import dataclasses
import hashlib
from typing import List, Optional, Tuple

ALLREDUCE = "ALLREDUCE"
ALLGATHER = "ALLGATHER"
BROADCAST = "BROADCAST"
ALLTOALL = "ALLTOALL"


@dataclasses.dataclass(frozen=True)
class RequestMeta:
    """One rank's submission metadata (reference: Request, message.h:45-98)."""
    rank: int
    op: str
    dtype: str                 # numpy dtype name ('float32', 'bfloat16', ...)
    shape: Tuple[int, ...]
    root_rank: int = -1
    average: bool = True

    def cache_key(self):
        return (self.op, self.dtype, self.shape, self.root_rank,
                bool(self.average))


@dataclasses.dataclass
class NegotiatedResponse:
    op: str
    error: Optional[str] = None
    # allgather: dim-0 size contributed by each rank, rank-ordered
    tensor_sizes: Optional[List[int]] = None
    root_rank: int = -1


def shape_str(shape):
    """Reference TensorShape::DebugString format '[d1, d2]'."""
    return "[" + ", ".join(str(d) for d in shape) + "]"


def participant_digest(reqs_by_rank):
    """Order-insensitive digest of one negotiation round's inputs.

    ``reqs_by_rank`` maps rank -> iterable of :class:`RequestMeta` (or
    of (name, RequestMeta) pairs). Two rounds that saw the same requests
    from the same ranks digest identically no matter what order the
    coordinator read or aggregated them in — the invariant the
    control-plane scale harness (controlplane/simrank.py) and the
    interleaving property tests assert to prove star, tree, and
    graduated rounds negotiate over identical inputs.
    """
    lines = []
    for rank in sorted(reqs_by_rank):
        for item in reqs_by_rank[rank]:
            name, req = item if isinstance(item, tuple) else ("", item)
            lines.append((int(rank), str(name), req.cache_key()))
    h = hashlib.sha256()
    for line in sorted(lines):
        h.update(repr(line).encode())
    return h.hexdigest()


def construct_response(name, reqs: List[RequestMeta], num_ranks,
                       ) -> NegotiatedResponse:
    """Validate all ranks' requests for one name.

    Wording parity: operations.cc:325-527 ("MPI operations" stays in the op
    mismatch text because reference tests assert on it).
    """
    first = reqs[0]
    resp = NegotiatedResponse(op=first.op, root_rank=first.root_rank)

    for r in reqs[1:]:
        if r.dtype != first.dtype:
            resp.error = (f"Mismatched data types: One rank had type "
                          f"{first.dtype}, but another rank had type "
                          f"{r.dtype}.")
            return resp
    for r in reqs[1:]:
        if r.op != first.op:
            resp.error = (f"Mismatched MPI operations: One rank did an "
                          f"{first.op.lower()}, but another rank did an "
                          f"{r.op.lower()}.")
            return resp
    if first.op in (ALLREDUCE, BROADCAST):
        for r in reqs[1:]:
            if r.shape != first.shape:
                resp.error = (f"Mismatched {first.op.lower()} tensor shapes: "
                              f"One rank sent a tensor of shape "
                              f"{shape_str(first.shape)}, but another rank "
                              f"sent a tensor of shape "
                              f"{shape_str(r.shape)}.")
                return resp
    if first.op == ALLGATHER:
        if len(first.shape) == 0:
            resp.error = (f"Rank zero tried to {first.op.lower()} a "
                          f"rank-zero tensor.")
            return resp
        sizes = [0] * num_ranks
        sizes[first.rank] = first.shape[0]
        for r in reqs[1:]:
            if len(r.shape) != len(first.shape):
                resp.error = (f"Mismatched {first.op.lower()} tensor shapes: "
                              f"One rank sent a tensor of rank "
                              f"{len(first.shape)}, but another rank sent a "
                              f"tensor of rank {len(r.shape)}.")
                return resp
            for dim in range(1, len(first.shape)):
                if r.shape[dim] != first.shape[dim]:
                    resp.error = (
                        f"Mismatched {first.op.lower()} tensor shapes: One "
                        f"rank sent a tensor with dimension {dim} equal to "
                        f"{first.shape[dim]}, but another rank sent a tensor "
                        f"with dimension {dim} equal to {r.shape[dim]}.")
                    return resp
            sizes[r.rank] = r.shape[0]
        resp.tensor_sizes = sizes
    if first.op == BROADCAST:
        for r in reqs[1:]:
            if r.root_rank != first.root_rank:
                resp.error = (f"Mismatched {first.op.lower()} root ranks: "
                              f"One rank specified root rank "
                              f"{first.root_rank}, but another rank "
                              f"specified root rank {r.root_rank}.")
                return resp
    if first.op == ALLTOALL:
        for r in reqs[1:]:
            if r.shape != first.shape:
                resp.error = (f"Mismatched {first.op.lower()} tensor shapes: "
                              f"One rank sent a tensor of shape "
                              f"{shape_str(first.shape)}, but another rank "
                              f"sent a tensor of shape "
                              f"{shape_str(r.shape)}.")
                return resp
        if len(first.shape) == 0 or first.shape[0] % num_ranks != 0:
            d0 = first.shape[0] if len(first.shape) else 0
            resp.error = (f"alltoall tensor dimension 0 ({d0}) must be "
                          f"divisible by the number of ranks ({num_ranks}).")
    return resp
