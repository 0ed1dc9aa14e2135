"""horovod_tpu_torch.tensorflow.keras: the tf.keras binding.

Counterpart of horovod_tpu/tensorflow/keras/ (upstream: the tf.keras
twin of horovod.keras, both over horovod/_keras/): the same objects as
horovod_tpu_torch.keras.
"""

from ...keras import (  # noqa: F401
    BroadcastGlobalVariablesCallback, Compression, DistributedOptimizer,
    LearningRateScheduleCallback, LearningRateWarmupCallback,
    MetricAverageCallback, allgather, allreduce, broadcast,
    broadcast_global_variables, broadcast_variables, init, load_model,
    local_rank, local_size, mpi_threads_supported, rank, shutdown, size)
