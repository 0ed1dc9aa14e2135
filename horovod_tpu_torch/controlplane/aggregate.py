"""Tree fan-in for the coordinator's per-round KV reads.

Counterpart of horovod_tpu/controlplane/aggregate.py, word for word.

Topology: the participant list, sorted, is cut into consecutive groups
of ``fanout``. The first pid of each group is its *head*. The root
(first pid overall — process 0 in a real job) reads its own group's
``req/{pid}`` keys directly plus ONE ``agg/{head}`` blob per other
group, so a round costs O(fanout + world/fanout) root reads instead of
O(world). Each non-root head batches its group's request blobs — and,
under elastic, the liveness counters and goodbye markers — into one
packed value, rewritten only when something in it changed (an idle
group costs its head reads but the store zero writes).

The pack format is deliberately dumb — magic + count + length-prefixed
(kind, pid, blob) records — because the payload blobs are already the
coordinator's wire formats (wire.py request lists, ``HVTE`` epoch
tokens, liveness counters) and must round-trip byte-exact: the root
feeds the unpacked bytes into exactly the same parse path a direct read
would have taken, which is what keeps star and tree decisions
bit-identical.

Failure shape: under elastic a dead head no
longer freezes its group. Every group's liveness counters tick
monotonically through its head's blob, so a healthy head's ``agg``
value keeps changing at the liveness cadence; the root runs a
:class:`HeadReceiptClock` over those blobs and, once a head's blob has
not moved within the staleness window, reads the whole group's
``req`` keys directly (:func:`fallback_members`) — the members stay
alive and coordinated, only the fan-in economy is lost until the head's
blob moves again. (The port's root reads every process's ``live`` and
``bye`` keys directly in its elastic round, coordinator.py
``elastic_round``; in the blob they are what keeps a healthy head's
value moving.) Without elastic there is no
liveness cadence to clock against, so a dead head still presents as
its group stalling, same as a dead member does in the star today.

Record kinds::

    R  request blob  (req/{pid} — wire RequestList or HVTE epoch token)
    L  liveness blob (live/{pid} — monotone counter, elastic only)
    B  goodbye blob  (bye/{pid} — planned-departure marker)
"""

import struct

# Distinct from wire.py's b"HVTP" and coordinator.py's b"HVTE" magics:
# an aggregated blob must never parse as a request list or epoch token.
AGG_MAGIC = b"HVTA"

KIND_REQ = "R"
KIND_LIVE = "L"
KIND_BYE = "B"

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


def group_heads(pids, fanout):
    """Heads of the non-root groups — the pids that run
    ``aggregate_round`` (the root reads its own group directly)."""
    return [g[0] for g in tree_groups(pids, fanout)[1:]]


def children_of(pid, pids, fanout):
    """The pids whose blobs ``pid`` batches: its whole group (itself
    included — the root reads only ``agg/{head}`` for foreign groups, so
    the head's own request must ride its own blob). Empty for the root
    and for non-head members."""
    for g in tree_groups(pids, fanout)[1:]:
        if g[0] == pid:
            return list(g)
    return []


def pack_entries(entries):
    """Serialize [(kind, pid, blob)] into one aggregated value."""
    parts = [_HEADER.pack(AGG_MAGIC, len(entries))]
    for kind, pid, blob in entries:
        blob = bytes(blob)
        parts.append(_ENTRY.pack(kind.encode(), int(pid), len(blob)))
        parts.append(blob)
    return b"".join(parts)


class HeadReceiptClock:
    """Root-side staleness tracker over ``agg/{head}`` blobs (elastic
    tree mode only). Under elastic every member's liveness counter ticks
    monotonically through its head's packed blob, so a live head's blob
    CHANGES at least every liveness cadence — a blob frozen past
    ``stale_after`` seconds means the head stopped sweeping, not that
    its group died. Pure walltime-in arithmetic (callers pass ``now``)
    so the policy is unit-testable without clocks or KV stores."""

    def __init__(self, stale_after):
        self.stale_after = float(stale_after)
        self._seen = {}         # head -> (blob bytes, time of last change)
        self._first_asked = {}  # head -> first time stale() considered it

    def note(self, head, blob, now):
        """Record one observation of a head's agg blob; the FIRST
        sighting counts as a change (a freshly elected head starts with
        full credit)."""
        blob = bytes(blob)
        prev = self._seen.get(head)
        if prev is None or prev[0] != blob:
            self._seen[head] = (blob, now)

    def stale(self, heads, now):
        """Heads whose blob has not changed within the window. Heads
        never observed at all (dead before their first write) get a 2x
        startup grace from when the root first asked about them."""
        out = set()
        for h in heads:
            rec = self._seen.get(h)
            if rec is not None:
                if now - rec[1] > self.stale_after:
                    out.add(h)
                continue
            t0 = self._first_asked.setdefault(h, now)
            if now - t0 > 2.0 * self.stale_after:
                out.add(h)
        return out

    def forget(self, head):
        """Drop a head's history (membership change: the pid left the
        layout or was declared lost)."""
        self._seen.pop(head, None)
        self._first_asked.pop(head, None)


def fallback_members(groups, stale):
    """Members the root must read DIRECTLY this round because their
    group's aggregator head is stale — the FULL group, head included
    (the head's own request rides its own blob, so a frozen blob hides
    the head's submissions too)."""
    out = []
    for g in groups[1:]:
        if g[0] in stale:
            out.extend(g)
    return out


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
