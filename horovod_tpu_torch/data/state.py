"""Checkpointable iterator state: where a distributed epoch stands.

Counterpart of horovod_tpu/data/state.py, copied (plain Python and the
sharding module's numpy).

A resumable input position is three things: which epoch, which global
sample order (the RNG seed — the order itself is re-derived, never
stored), and how far into that order the *job* has consumed. Because
mid-epoch membership changes re-shard the remainder, "how far" is a
short **segment history** rather than one offset::

    segments = [[4, 2], [3, 0]]
    #            |  |    '--- current segment: 3 ranks, 0 steps taken
    #            |  '-- ...committed 2 lockstep steps, then membership
    #            '---- the epoch started with 4 ranks...

Replaying the history against the epoch permutation
(:func:`sharding.remaining_after` per completed segment) reconstructs
the exact unconsumed remainder on any process, so the whole position
serializes as a dict of small ints — it drops into
``elastic.State`` fields, ``CheckpointManager`` payloads, or any JSON
sidecar unchanged.

:func:`attach_to_state` wires a :class:`~horovod_tpu_torch.data.DistributedDataset`
into an ``elastic.State``: every ``commit()`` snapshots the live
position (commit hook), and every ``restore()`` rewinds the dataset to
the committed one (reset callback) — re-sharding across the survivors
when the restore follows a membership change. The SIGKILL-recovery
contract this buys: samples consumed after the last commit are rolled
back *together with* the model update they fed, so the resumed epoch
covers every sample exactly once (pad duplicates aside).
"""

from . import sharding


class IteratorState:
    """Value object for a dataset position (epoch, seed, segment
    history). ``to_dict``/``from_dict`` are the checkpoint codec."""

    __slots__ = ("epoch", "seed", "shuffle", "segments")

    def __init__(self, epoch=0, seed=0, shuffle=True, segments=None):
        self.epoch = int(epoch)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        # [[size, steps], ...]; the LAST entry is the live segment.
        self.segments = [[int(s), int(k)] for s, k in (segments or [])]

    def to_dict(self):
        return {"epoch": self.epoch, "seed": self.seed,
                "shuffle": self.shuffle,
                "segments": [list(s) for s in self.segments]}

    @classmethod
    def from_dict(cls, d):
        return cls(epoch=d.get("epoch", 0), seed=d.get("seed", 0),
                   shuffle=d.get("shuffle", True),
                   segments=d.get("segments") or [])

    def begin_epoch(self, epoch, size):
        self.epoch = int(epoch)
        self.segments = [[int(size), 0]]


def rebuild_plan(num_samples, state, rank, size, batch_size,
                 policy="contiguous", remainder="pad"):
    """Reconstruct this rank's index plan from an :class:`IteratorState`.

    Replays the segment history against the epoch permutation. When the
    live segment's recorded world size differs from ``size`` (a
    membership change), the remainder left by that segment is re-sharded
    across the new rank set and a fresh segment is appended — the state
    is MUTATED to record the re-shard. Returns ``(plan, step)``: the
    rank's remaining-epoch index array and how many of its batches are
    already consumed.
    """
    g = sharding.epoch_permutation(num_samples, state.epoch, state.seed,
                                   state.shuffle)
    if not state.segments:
        state.begin_epoch(state.epoch, size)
    resharded = False
    for seg_size, seg_steps in state.segments[:-1]:
        g = sharding.remaining_after(g, seg_steps, seg_size, batch_size,
                                     policy, remainder)
    seg_size, seg_steps = state.segments[-1]
    if seg_size != size:
        g = sharding.remaining_after(g, seg_steps, seg_size, batch_size,
                                     policy, remainder)
        state.segments.append([int(size), 0])
        seg_steps = 0
        resharded = True
    plan = sharding.shard_indices(g, rank, size, batch_size, policy,
                                  remainder)
    return plan, int(seg_steps), resharded


def samples_consumed(num_samples, state, batch_size, policy="contiguous",
                     remainder="pad"):
    """How many of the epoch's samples the job has consumed at this
    position (pad duplicates counted once) — replays the segment history
    exactly like :func:`rebuild_plan`, so the number is consistent on
    every process and across membership changes. The churn-soak harness
    and job summaries use it to assert exact-once coverage without
    shipping index sets around."""
    if isinstance(state, dict):
        state = IteratorState.from_dict(state)
    g = sharding.epoch_permutation(num_samples, state.epoch, state.seed,
                                   state.shuffle)
    for seg_size, seg_steps in state.segments:
        g = sharding.remaining_after(g, seg_steps, seg_size, batch_size,
                                     policy, remainder)
    return num_samples - len(g)


def attach_to_state(elastic_state, dataset, field="data_iter"):
    """Keep ``dataset``'s position inside an ``elastic.State``.

    - a **commit hook** refreshes ``elastic_state.<field>`` with the live
      ``dataset.state_dict()`` at the top of every ``commit()``, so the
      rollback point always pairs the model state with the input
      position that produced it;
    - a **reset callback** rewinds the dataset to the committed position
      after every ``restore()`` — and because ``load_state_dict`` reads
      the CURRENT topology, a restore that follows a membership change
      re-shards the unconsumed remainder across the survivors.

    Returns ``elastic_state`` for chaining.
    """
    setattr(elastic_state, field, dataset.state_dict())
    if hasattr(elastic_state, "register_commit_hook"):
        elastic_state.register_commit_hook(
            lambda: setattr(elastic_state, field, dataset.state_dict()))
    elastic_state.register_reset_callback(
        lambda: dataset.load_state_dict(getattr(elastic_state, field)))
    return elastic_state
