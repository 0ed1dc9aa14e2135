"""Error types of the port, with the JAX package's wording.

Counterpart of horovod_tpu/exceptions.py, carrying what the training
slice, the eager engine, the guard, checkpoints and elastic training
raise. The messages are the reference's, word for word, because
users and tests match on them.
"""


class HorovodError(Exception):
    """Base class for all horovod_tpu_torch errors."""


class NotInitializedError(HorovodError):
    """Raised when the library is used before init()."""

    def __init__(self):
        super().__init__("Horovod has not been initialized; use hvd.init().")


class ShutDownError(HorovodError):
    """Raised for operations submitted after shutdown."""

    def __init__(self):
        super().__init__(
            "Horovod has been shut down. This was caused by an exception on one of "
            "the ranks or an attempt to allreduce, allgather or broadcast a tensor "
            "after one of the ranks finished execution. If the shutdown was caused "
            "by an exception, you should see the exception in the log before the "
            "first shutdown message.")


class DuplicateNameError(HorovodError):
    """Raised when a tensor name is enqueued twice concurrently by one rank.

    Wording parity: reference horovod/common/operations.cc:142-145.
    """

    def __init__(self):
        super().__init__(
            "Requested to allreduce, allgather, or broadcast a tensor with the same "
            "name as another tensor that is currently being processed.  If you want "
            "to request another tensor, use a different tensor name.")


class MismatchError(HorovodError):
    """Coordinator-detected cross-rank inconsistency.

    The message text is produced by the negotiation logic with the reference's
    wording (reference: horovod/common/operations.cc:325-527 ConstructResponse).
    """


class StalledTensorError(HorovodError):
    """Raised when the stall watchdog shuts down a stuck collective.

    Mirrors the stall-shutdown path (reference: horovod/common/operations.cc:815-896).
    """


class CoordinatorError(HorovodError):
    """The coordination store itself is unreachable: repeated
    transport-level failures against the session's key-value store (as
    opposed to ordinary blocking-get timeouts), so a dead store is never
    misdiagnosed as a peer stall
    (coordinator.py::MultiHostCoordinator._transport_failure).
    """



class TransientCollectiveError(HorovodError):
    """A wire/dispatch failure believed to be transient (an injected
    chaos fault, or a runtime error the bounded retry policy is allowed
    to absorb). With ``HOROVOD_GUARD_RETRY > 0`` the engine retries the
    dispatch with exponential backoff before escalating; with the
    default (0) it propagates like any other dispatch failure.
    """


class CheckpointCorruptError(HorovodError):
    """A checkpoint's sidecar content digest failed verification at
    restore: the bytes on disk are not the bytes that were saved.
    ``CheckpointManager.restore()`` raises this only when an EXPLICIT
    step was requested; latest-step restores skip the corrupt candidate
    and fall back to the next-newest valid checkpoint instead.
    """


class WorkerLostError(HorovodError):
    """A peer worker process was lost: the elastic failure detector saw
    no liveness heartbeat from it within HOROVOD_ELASTIC_TIMEOUT_SECONDS,
    or a collective with it failed (its connection closed, or the
    process group's timeout, which is that same knob, expired). In-flight
    collectives fail with this instead of hanging; catching it (usually
    through :func:`horovod_tpu_torch.elastic.run`) and re-rendezvousing
    with the survivors is the recovery path.
    """

    def __init__(self, lost_pids=(), epoch=0, message=None):
        self.lost_pids = tuple(lost_pids)
        self.epoch = int(epoch)
        if message is None:
            who = ", ".join(str(p) for p in self.lost_pids) or "unknown"
            message = (
                f"Worker process(es) [{who}] declared lost: no liveness "
                f"heartbeat within the elastic timeout. In-flight "
                f"collectives were aborted; re-rendezvous with the "
                f"surviving workers (horovod_tpu.elastic.run) or restart "
                f"the job to continue.")
        super().__init__(message)


class HostsUpdatedError(HorovodError):
    """Worker membership is changing (a planned departure, or a
    cooperative hosts-updated interrupt) and collectives must
    re-rendezvous before continuing. Unlike :class:`WorkerLostError`
    nothing failed.
    """

    def __init__(self, epoch=0, message=None, lost_pids=()):
        self.lost_pids = tuple(lost_pids)
        self.epoch = int(epoch)
        if message is None:
            if self.lost_pids:
                who = ", ".join(str(p) for p in self.lost_pids)
                message = (
                    f"Worker process(es) [{who}] announced a planned "
                    f"departure (preemption grace); collectives were "
                    f"interrupted so the survivors re-shard at this step "
                    f"boundary (horovod_tpu.elastic.run resumes "
                    f"training automatically).")
            else:
                message = (
                    "Worker membership updated; collectives were "
                    "interrupted for re-rendezvous (horovod_tpu.elastic."
                    "run resumes training automatically after rebuilding "
                    "the mesh).")
        super().__init__(message)
