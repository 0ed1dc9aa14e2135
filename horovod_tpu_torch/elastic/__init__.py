"""horovod_tpu_torch.elastic: fault-tolerant training: failure
detection, worker supervision policy, and checkpoint-based recovery.

Counterpart of horovod_tpu/elastic/ (upstream analog: v0.20 "Elastic
Horovod"). A dead worker becomes a bounded-time recovery, in layers:

1. **detection**: under ``HOROVOD_ELASTIC`` the process group times a
   collective out after ``HOROVOD_ELASTIC_TIMEOUT_SECONDS`` and a
   failed collective raises
   :class:`~horovod_tpu_torch.exceptions.WorkerLostError`
   (ops/collectives.py ``peer_error``); the coordinator's liveness
   beacons and lost-worker scan abort the eager engine's handles the
   same way (coordinator.py);
2. **state commit/rollback** (:class:`State`): host snapshots written
   back in place, with durable commits through
   ``checkpoint.CheckpointManager``;
3. **rendezvous** (:func:`rendezvous`): generation-numbered membership
   agreement over the job's store, after which :func:`run` re-inits over
   the survivors (``hvd.init(comm=...)``);
4. **supervision** (:mod:`supervisor`): exit classification and restart
   backoff, for the launcher (run/run.py);
5. **policy** (:mod:`policy`): the autoscaler's signals and decisions,
   paired with the SIGTERM preemption grace of :mod:`runner`
   (``HOROVOD_ELASTIC_GRACE_SECONDS``).
"""

from .policy import (AutoscalePolicy, ScaleDecision,  # noqa: F401
                     aggregate_signals, compact_signals, read_signals,
                     write_signal, write_signal_bundle)
from .rendezvous import rendezvous  # noqa: F401
from .runner import (install_preemption_grace,  # noqa: F401
                     notify_hosts_updated, preemption_requested, run)
from .state import State  # noqa: F401
from .supervisor import (EX_PREEMPTED, RestartPolicy,  # noqa: F401
                         classify_exit, describe_exit)
