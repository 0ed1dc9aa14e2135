"""What each gloo rank runs in the framework bindings' tests
(tests/test_torch_tensorflow_binding.py, test_torch_mxnet_binding.py),
through tests/torch_ranks.py's ``spawn_ranks``. No JAX here: every rank
imports this module. Each function returns numpy arrays and plain
values."""

import os
import sys

import numpy as np


def tensorflow_ranks(inp):
    """Two ranks of the TensorFlow and Keras bindings, each with its own
    values: the dense average and sum, the IndexedSlices path,
    DistributedGradientTape's gradient, one DistributedOptimizer step,
    the keras broadcast callback and the metric average."""
    import tensorflow as tf

    import horovod_tpu_torch.keras as khvd
    import horovod_tpu_torch.tensorflow as hvd
    hvd.init(device="cpu")
    r = hvd.rank()
    x = tf.constant(inp["x"][r])
    out = {"mean": hvd.allreduce(x, name="b.mean").numpy(),
           "sum": hvd.allreduce(x, average=False, name="b.sum").numpy()}
    sl = hvd.allreduce(tf.IndexedSlices(x, tf.constant([0, 2]),
                                        dense_shape=tf.constant([4, 2])),
                       name="b.slices")
    out["slices_values"] = sl.values.numpy()
    out["slices_indices"] = sl.indices.numpy()
    w = tf.Variable(tf.ones(x.shape))
    with hvd.DistributedGradientTape() as tape:
        loss = tf.reduce_sum(w * x)
    out["tape"] = tape.gradient(loss, [w])[0].numpy()
    v = tf.Variable(tf.constant(inp["w"][0]))
    opt = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(0.1))
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(v * tf.constant(inp["w"][r]))
    opt.apply_gradients(zip(tape.gradient(loss, [v]), [v]))
    out["opt_w"] = v.numpy()
    model = tf.keras.Sequential([tf.keras.Input((1,)),
                                 tf.keras.layers.Dense(3, use_bias=False)])
    model.layers[0].kernel.assign(inp["w"][r].reshape(1, 3))
    cb = khvd.BroadcastGlobalVariablesCallback(0)
    cb.set_model(model)
    cb.on_train_begin()
    out["bcast"] = model.layers[0].kernel.numpy().ravel()
    logs = {"loss": inp["metric"][r]}
    khvd.MetricAverageCallback().on_epoch_end(0, logs)
    out["metric"] = logs["loss"]
    hvd.shutdown()
    return out


def mxnet_ranks(inp):
    """Two ranks of the MXNet binding over tests/mxnet_mock.py: the
    average and sum, the gather, the root's broadcast and one
    DistributedTrainer step."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_mock as mx
    sys.modules["mxnet"] = mx
    import horovod_tpu_torch.mxnet as hvd
    hvd.init(device="cpu")
    r = hvd.rank()
    x = mx.nd.array(inp["x"][r])
    out = {"mean": hvd.allreduce(x, name="m.mean").asnumpy(),
           "sum": hvd.allreduce(x, average=False, name="m.sum").asnumpy(),
           "gather": hvd.allgather(x, name="m.gather").asnumpy(),
           "bcast": hvd.broadcast(x, 0, name="m.bcast").asnumpy()}
    p = mx.Parameter("p", data=np.ones(3, np.float32),
                     grad=np.array(inp["g"][r]))
    trainer = hvd.DistributedTrainer(
        [p], mx.Optimizer(learning_rate=1.0, rescale_grad=1.0))
    trainer.step(batch_size=1)
    out["trained"] = p.data().asnumpy()
    hvd.shutdown()
    return out
