"""Deterministic, seed-driven sharding of one global sample order.

Counterpart of horovod_tpu/data/sharding.py, copied: numpy's Philox
stream keyed by (seed, epoch), so the port's global order and every
rank's slice equal the JAX package's sample for sample.

The data-parallel contract (PAPER.md; reference: the Horovod examples'
hand-rolled ``dataset.shard(hvd.size(), hvd.rank())`` idiom) is that
every rank steps through an identically-sized, disjoint slice of the
input. Two properties make that safe to distribute without any runtime
coordination:

1. **Determinism** — the global sample order for epoch ``e`` is a pure
   function of ``(seed, e)``: every rank computes the same permutation
   locally (:func:`epoch_permutation`), so there is no "rank 0 shuffles
   and broadcasts" step and a restarted worker re-derives the exact
   order it crashed out of.
2. **The equal-steps invariant** — :func:`shard_indices` returns shards
   whose length is *identical on every rank* (``steps x batch_size``).
   Collectives negotiate per step; a rank that ran out of batches one
   step early would leave its peers wedged inside an allreduce (the
   stall the reference can only report, operations.cc:815-896). The
   ``remainder`` policy decides how the uneven tail meets the
   invariant: ``"pad"`` wraps around the global order (a handful of
   early samples repeat — never a hang), ``"drop"`` discards the
   remainder (every consumed sample is unique — a handful never seen
   this epoch). Petastorm ships the same two choices as
   ``cur_shard``/``shard_count`` + padding for exactly this reason.

Sharding policies:

- ``"contiguous"`` — rank ``r`` takes the ``r``-th block of the
  (padded) global order; friendly to sources with locality (sequential
  file reads).
- ``"strided"`` — rank ``r`` takes elements ``r, r+size, r+2*size...``;
  after ``k`` lockstep steps the job as a whole has consumed exactly
  the first ``k*batch*size`` elements of the global order, which makes
  mid-epoch progress a single integer.

:func:`remaining_after` inverts either policy: given how many lockstep
steps a ``size``-rank job committed, it returns the global-order
samples no rank has consumed — the input to re-sharding the rest of
the epoch across the survivors of a membership change (loader.py /
elastic recovery).
"""

import numpy as np

POLICIES = ("contiguous", "strided")
REMAINDERS = ("pad", "drop")


def _check(policy, remainder):
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    if remainder not in REMAINDERS:
        raise ValueError(
            f"remainder must be one of {REMAINDERS}, got {remainder!r}")


def epoch_permutation(num_samples, epoch=0, seed=0, shuffle=True):
    """The global sample order for one epoch: a permutation of
    ``arange(num_samples)`` that is a pure function of ``(seed, epoch)``
    — identical on every rank, different across epochs. ``shuffle=False``
    returns the natural order (the permutation is then the identity and
    only the sharding varies by rank)."""
    if num_samples < 0:
        raise ValueError(f"num_samples must be >= 0, got {num_samples}")
    if not shuffle:
        return np.arange(num_samples, dtype=np.int64)
    # Philox keyed by (seed, epoch): counter-based, so the stream is
    # stable across numpy versions/platforms in a way the default
    # generator's seeding path also guarantees via SeedSequence.
    rng = np.random.Generator(np.random.Philox(
        key=np.array([seed & 0xFFFFFFFFFFFFFFFF,
                      epoch & 0xFFFFFFFFFFFFFFFF], dtype=np.uint64)))
    return rng.permutation(num_samples).astype(np.int64)


def steps_for(num_samples, size, batch_size, remainder="pad"):
    """Steps every rank takes over ``num_samples`` (the equal-steps
    invariant makes this a job-wide constant, not a per-rank one)."""
    _check("contiguous", remainder)
    if size <= 0 or batch_size <= 0:
        raise ValueError("size and batch_size must be positive")
    if num_samples <= 0:
        return 0
    if remainder == "drop":
        return num_samples // size // batch_size
    per_rank = -(-num_samples // size)          # ceil
    return -(-per_rank // batch_size)           # ceil


def shard_indices(indices, rank, size, batch_size=1, policy="contiguous",
                  remainder="pad"):
    """This rank's slice of the global order, padded or trimmed so that
    ``len(result) == steps_for(...) * batch_size`` on EVERY rank.

    ``indices`` is the global order: an int (meaning ``arange(n)``) or a
    1-D index array (e.g. an :func:`epoch_permutation`, or the
    :func:`remaining_after` tail of one). Padding wraps the global order
    from its start, so pad duplicates are deterministic and shared
    knowledge — every rank can tell exactly which trailing entries of
    which shard are repeats.
    """
    _check(policy, remainder)
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} out of range for size {size}")
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    if isinstance(indices, (int, np.integer)):
        g = np.arange(int(indices), dtype=np.int64)
    else:
        g = np.asarray(indices, dtype=np.int64)
        if g.ndim != 1:
            raise ValueError(f"indices must be 1-D, got shape {g.shape}")
    n = len(g)
    steps = steps_for(n, size, batch_size, remainder)
    per_rank = steps * batch_size
    if per_rank == 0:
        return np.empty(0, dtype=np.int64)
    total = per_rank * size
    if total <= n:
        flat = g[:total]
    else:
        flat = g[np.arange(total) % n]  # wrap-around pad
    if policy == "contiguous":
        return flat.reshape(size, per_rank)[rank].copy()
    return flat.reshape(per_rank, size)[:, rank].copy()


def remaining_after(indices, steps_done, size, batch_size=1,
                    policy="contiguous", remainder="pad"):
    """Global-order samples NO rank has consumed after ``steps_done``
    lockstep steps of a ``size``-rank job — in global-order, each exactly
    once (pad duplicates collapse onto their first consumption).

    This is the epoch's unconsumed remainder: re-sharding it across a
    new rank set (:func:`shard_indices` again) continues the epoch after
    a membership change without duplicating or dropping a sample.
    """
    _check(policy, remainder)
    if isinstance(indices, (int, np.integer)):
        g = np.arange(int(indices), dtype=np.int64)
    else:
        g = np.asarray(indices, dtype=np.int64)
    if steps_done <= 0:
        return g.copy()
    head = steps_done * batch_size
    consumed = np.concatenate([
        shard_indices(g, r, size, batch_size, policy, remainder)[:head]
        for r in range(size)]) if size > 0 else np.empty(0, np.int64)
    return g[~np.isin(g, consumed)]
