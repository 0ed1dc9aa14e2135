"""horovod_tpu_torch.data: the distributed input-data subsystem.

Counterpart of horovod_tpu/data/. Every rank steps through an
identically sized, disjoint shard of the input:

- :mod:`sharding`: deterministic, seed-driven per-epoch global shuffle
  and rank slicing (contiguous/strided), with a pad-or-drop remainder
  policy that keeps the equal-steps invariant the collectives need;
- :class:`DistributedDataset` (loader.py): the batch iterator, with a
  bounded background prefetch (``HOROVOD_DATA_PREFETCH``; 0 =
  synchronous) that stages batches on the card through pinned memory;
- :mod:`state` / :func:`attach_to_state`: the checkpointable iterator
  position (epoch, seed, segment history) that plugs into
  ``elastic.State``: a SIGKILL recovery resumes mid-epoch without
  duplicating or dropping samples and re-shards the rest of the epoch
  across the survivors.
"""

from .loader import DistributedDataset, process_topology  # noqa: F401
from .sharding import (POLICIES, REMAINDERS, epoch_permutation,  # noqa: F401
                       remaining_after, shard_indices, steps_for)
from .state import (IteratorState, attach_to_state,  # noqa: F401
                    rebuild_plan, samples_consumed)
