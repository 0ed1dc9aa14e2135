"""horovod_tpu_torch.keras: the Keras binding.

Counterpart of horovod_tpu/keras/ (upstream: horovod/keras/__init__.py
and horovod/_keras/): a ``DistributedOptimizer`` for Keras optimizers,
``load_model`` that wraps a restored optimizer again, and the callbacks
(BroadcastGlobalVariables, MetricAverage, LearningRateSchedule and
Warmup). The optimizer wrap is horovod_tpu_torch.tensorflow's (Keras
optimizers are tf.keras optimizers here); the callbacks adapt the
port's framework-free ones (callbacks.py) to ``keras.callbacks.Callback``.
"""

import tensorflow as tf

from .. import callbacks as _cb
from .. import runtime as _rt
from ..tensorflow import (Compression, DistributedOptimizer,  # noqa: F401
                          allgather, allreduce, broadcast,
                          broadcast_variables)

init = _rt.init
shutdown = _rt.shutdown
size = _rt.size
local_size = _rt.local_size
rank = _rt.rank
local_rank = _rt.local_rank
mpi_threads_supported = _rt.mpi_threads_supported


class BroadcastGlobalVariablesCallback(tf.keras.callbacks.Callback):
    """(upstream: _keras/callbacks.py:20-31)"""

    def __init__(self, root_rank=0):
        super().__init__()
        self.root_rank = root_rank

    def on_train_begin(self, logs=None):
        broadcast_variables(self.model.variables, self.root_rank)


class MetricAverageCallback(tf.keras.callbacks.Callback):
    """(upstream: _keras/callbacks.py:33-67)"""

    def __init__(self):
        super().__init__()
        self._impl = _cb.MetricAverageCallback()

    def on_epoch_end(self, epoch, logs=None):
        self._impl.on_epoch_end(epoch, logs)


class _KerasLRBackendMixin:
    """Bridges the agnostic schedule impl to keras optimizer attributes."""

    def _wrap(self, impl):
        self._impl = impl

    def set_params(self, params):
        super().set_params(params)
        self._impl.set_params(params)

    def on_train_begin(self, logs=None):
        self._impl.on_train_begin(logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._impl.on_epoch_begin(epoch, logs)

    def on_batch_begin(self, batch, logs=None):
        self._impl.on_batch_begin(batch, logs)

    def on_batch_end(self, batch, logs=None):
        self._impl.on_batch_end(batch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._impl.on_epoch_end(epoch, logs)


class _KerasOptProxy:
    """Exposes keras-3 optimizer hyperparams as plain attributes."""

    def __init__(self, model_holder):
        self._holder = model_holder

    @property
    def _opt(self):
        return self._holder.model.optimizer

    @property
    def lr(self):
        return float(tf.keras.backend.get_value(self._opt.learning_rate))

    @lr.setter
    def lr(self, v):
        self._opt.learning_rate.assign(v)

    @property
    def momentum(self):
        return float(tf.keras.backend.get_value(self._opt.momentum))

    @momentum.setter
    def momentum(self, v):
        # keras-3 SGD keeps momentum as a plain float attribute; older
        # optimizers used a Variable
        m = self._opt.momentum
        if hasattr(m, "assign"):
            m.assign(v)
        else:
            self._opt.momentum = float(v)


class LearningRateScheduleCallback(_KerasLRBackendMixin,
                                   tf.keras.callbacks.Callback):
    """(upstream: _keras/callbacks.py:70-146)"""

    def __init__(self, multiplier, start_epoch=0, end_epoch=None,
                 staircase=True, momentum_correction=True,
                 steps_per_epoch=None):
        super().__init__()
        proxy = _KerasOptProxy(self)
        self._wrap(_cb.LearningRateScheduleCallback(
            proxy, multiplier, start_epoch=start_epoch, end_epoch=end_epoch,
            staircase=staircase, momentum_correction=momentum_correction,
            steps_per_epoch=steps_per_epoch))


class LearningRateWarmupCallback(_KerasLRBackendMixin,
                                 tf.keras.callbacks.Callback):
    """(upstream: _keras/callbacks.py:149-168)"""

    def __init__(self, warmup_epochs=5, momentum_correction=True,
                 steps_per_epoch=None, verbose=0):
        super().__init__()
        proxy = _KerasOptProxy(self)
        self._wrap(_cb.LearningRateWarmupCallback(
            proxy, warmup_epochs=warmup_epochs,
            momentum_correction=momentum_correction,
            steps_per_epoch=steps_per_epoch, verbose=verbose))


def broadcast_global_variables(root_rank):
    """Keras twin of horovod_tpu_torch.tensorflow.broadcast_global_variables
    (upstream: keras/__init__.py broadcast_global_variables over the
    backend session). Works for tf.compat.v1-built graphs; native TF2
    keras code should use BroadcastGlobalVariablesCallback or
    broadcast_variables(model.variables, root)."""
    from .. import tensorflow as _tf_binding
    return _tf_binding.broadcast_global_variables(root_rank)


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=None):
    """Load a keras model saved with a DistributedOptimizer: every keras
    optimizer class (plus any ``custom_optimizers``) is re-mapped to its
    Distributed-wrapped subclass during deserialization, so the restored
    optimizer allreduces again (upstream: keras/__init__.py::load_model ->
    _keras/__init__.py:93-109).

    ``compression`` applies to the re-created optimizer wrappers."""
    from ..tensorflow import _make_distributed_optimizer_class

    def wrap(cls):
        return _make_distributed_optimizer_class(cls,
                                                 compression=compression)

    def all_subclasses(base):
        # transitive walk: keras versions interpose intermediate classes
        # between Optimizer and the concrete SGD/Adam/..., and user
        # optimizers subclass the concrete ones — direct __subclasses__()
        # would miss both (upstream walks the optimizer modules
        # instead, _keras/__init__.py:93-109)
        seen = set()
        stack = list(base.__subclasses__())
        while stack:
            cls = stack.pop()
            if cls in seen:
                continue
            seen.add(cls)
            stack.extend(cls.__subclasses__())
        # never re-wrap wrapper classes minted by an earlier
        # DistributedOptimizer/load_model call (they subclass the concrete
        # optimizers, so the transitive walk reaches them)
        return {c for c in seen
                if not getattr(c, "_hvd_distributed_wrapper", False)}

    horovod_objects = {}
    for subclass in all_subclasses(tf.keras.optimizers.Optimizer):
        # a model saved with a wrapped optimizer records the wrapper's
        # class name ("DistributedSGD"); one saved plain records "SGD" (or
        # the legacy lowercase form upstream maps,
        # _keras/__init__.py:94-98) — cover all three
        wrapped = wrap(subclass)
        horovod_objects[subclass.__name__.lower()] = wrapped
        horovod_objects[subclass.__name__] = wrapped
        horovod_objects["Distributed" + subclass.__name__] = wrapped
    if custom_optimizers is not None:
        for cls in custom_optimizers:
            wrapped = wrap(cls)
            horovod_objects[cls.__name__] = wrapped
            horovod_objects["Distributed" + cls.__name__] = wrapped
    if custom_objects is not None:
        horovod_objects.update(custom_objects)
    return tf.keras.models.load_model(filepath,
                                      custom_objects=horovod_objects)
