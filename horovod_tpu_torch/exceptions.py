"""Error types of the port, with the JAX package's wording.

Counterpart of horovod_tpu/exceptions.py, carrying what the training
slice and the eager engine raise. The messages are the reference's, word for word, because
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

