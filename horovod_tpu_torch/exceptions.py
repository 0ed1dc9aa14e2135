"""Error types of the port, with the JAX package's wording.

Counterpart of horovod_tpu/exceptions.py, carrying what the training
slice raises. The messages are the reference's, word for word, because
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
