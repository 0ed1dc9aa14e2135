"""Tree fan-in for the coordinator's per-round KV reads.

Topology: the participant list, sorted, is cut into consecutive groups
of ``fanout``. The first pid of each group is its *head*. The root
(first pid overall — process 0 in a real job) reads its own group's
``req/{pid}`` keys directly plus ONE ``agg/{head}`` blob per other
group, so a round costs O(fanout + world/fanout) root reads instead of
O(world). Each non-root head batches its group's request blobs into one
packed value, rewritten only when something in it changed (an idle
group costs its head reads but the store zero writes).

The pack format is deliberately dumb — magic + count + length-prefixed
(kind, pid, blob) records — because the payload blobs are already the
coordinator's wire formats (wire.py request lists, ``HVTE`` epoch
tokens) and must round-trip byte-exact: the root
feeds the unpacked bytes into exactly the same parse path a direct read
would have taken, which is what keeps star and tree decisions
bit-identical.

A dead head presents as its group stalling, as a dead member does in
the star. The reference's stale-head fallback (a receipt clock over the
heads' blobs, kept moving by the elastic liveness counters) comes with
elastic training (ROADMAP.md, Queue 1 item 15).

Record kinds::

    R  request blob  (req/{pid} — wire RequestList or HVTE epoch token)
"""

import struct

# Distinct from wire.py's b"HVTP" and coordinator.py's b"HVTE" magics:
# an aggregated blob must never parse as a request list or epoch token.
AGG_MAGIC = b"HVTA"

KIND_REQ = "R"

_HEADER = struct.Struct("!4sI")
_ENTRY = struct.Struct("!cIQ")


def tree_groups(pids, fanout):
    """Consecutive ``fanout``-sized slices of the sorted pid list. The
    first group contains the root; every later group's first pid is its
    aggregator head."""
    fanout = int(fanout)
    if fanout < 2:
        raise ValueError(f"tree fanout must be >= 2, got {fanout}")
    pids = sorted(pids)
    return [pids[i:i + fanout] for i in range(0, len(pids), fanout)]


def pack_entries(entries):
    """Serialize [(kind, pid, blob)] into one aggregated value."""
    parts = [_HEADER.pack(AGG_MAGIC, len(entries))]
    for kind, pid, blob in entries:
        blob = bytes(blob)
        parts.append(_ENTRY.pack(kind.encode(), int(pid), len(blob)))
        parts.append(blob)
    return b"".join(parts)


def unpack_entries(blob):
    """Inverse of :func:`pack_entries`; raises ValueError on anything
    that is not a well-formed aggregated value (a truncated write must
    fail loud, not feed half a group into the decision round)."""
    blob = bytes(blob)
    magic, count = _HEADER.unpack_from(blob, 0)
    if magic != AGG_MAGIC:
        raise ValueError(f"not an aggregated blob (magic {magic!r})")
    out = []
    off = _HEADER.size
    for _ in range(count):
        kind, pid, n = _ENTRY.unpack_from(blob, off)
        off += _ENTRY.size
        if off + n > len(blob):
            raise ValueError("aggregated blob truncated mid-record")
        out.append((kind.decode(), pid, blob[off:off + n]))
        off += n
    if off != len(blob):
        raise ValueError("aggregated blob has trailing bytes")
    return out
