"""The port's Spark integration (horovod_tpu_torch/spark/) against the
JAX package's (horovod_tpu/spark/), over the port's run/ services.

Spec: tests/test_spark.py, function for function. pyspark is installed
nowhere here, so the local backend (the same driver and task protocol,
one spawned process a rank) carries the round trips, and the Spark gate
is asserted directly. The rank assignment of the same registrations is
held to the reference's driver field for field; a collective's result
to numpy's sum of the seeded inputs, exactly.
"""

import numpy as np
import pytest

import horovod_tpu_torch.spark as hvd_spark
from horovod_tpu.run.rpc import make_secret_key as jmake_secret_key
from horovod_tpu.run.services import DriverClient as JDriverClient
from horovod_tpu.spark.driver import SparkDriverService as JDriverService
from horovod_tpu_torch.run.rpc import make_secret_key
from horovod_tpu_torch.run.services import DriverClient
from horovod_tpu_torch.spark.driver import SparkDriverService


def _make_rank_env_fn():
    # a closure, so cloudpickle ships it by value (a module-level test fn
    # would be pickled by reference and fail to import in the task)
    def fn():
        import os
        return (int(os.environ["HOROVOD_RANK"]),
                int(os.environ["HOROVOD_SIZE"]),
                int(os.environ["HOROVOD_LOCAL_RANK"]))
    return fn


def test_spark_backend_requires_pyspark():
    with pytest.raises(ImportError, match="pyspark"):
        hvd_spark.run(_make_rank_env_fn(), num_proc=2, backend="spark")


def test_run_local_backend_round_trip():
    results = hvd_spark.run(_make_rank_env_fn(), num_proc=3,
                            backend="local", start_timeout=60)
    assert [r for r, _, _ in results] == [0, 1, 2]  # rank-ordered
    assert {size for _, size, _ in results} == {3}
    # one host: local rank == rank
    assert [lr for _, _, lr in results] == [0, 1, 2]


def test_run_passes_args_and_kwargs():
    def fn_with_args(a, b, scale=1):
        import os
        return (a + b) * scale + int(os.environ["HOROVOD_RANK"])

    results = hvd_spark.run(fn_with_args, args=(2, 3),
                            kwargs={"scale": 10}, num_proc=2,
                            backend="local", start_timeout=60)
    assert results == [50, 51]


def test_run_surfaces_task_failure():
    def failing_fn():
        import os
        if int(os.environ["HOROVOD_RANK"]) == 1:
            raise ValueError("boom on rank 1")
        return "ok"

    with pytest.raises(RuntimeError, match="boom on rank 1"):
        hvd_spark.run(failing_fn, num_proc=2, backend="local",
                      start_timeout=60)


def test_run_rejects_bad_num_proc():
    with pytest.raises(ValueError, match="num_proc"):
        hvd_spark.run(_make_rank_env_fn(), num_proc=0, backend="local")


def _assign(service_cls, client_cls, key):
    driver = service_cls(num_proc=4, key=key)
    try:
        client = client_cls(driver.addresses(), key)
        # two tasks per synthetic host, registered out of order
        client.register_task(2, [("10.0.0.2", 1002)], "host-b")
        client.register_task(0, [("10.0.0.1", 1000)], "host-a")
        client.register_task(3, [("10.0.0.2", 1003)], "host-b")
        client.register_task(1, [("10.0.0.1", 1001)], "host-a")
        driver.wait_for_initial_registration(timeout=5)
        return {i: vars(a) for i, a in driver.compute_assignments().items()}
    finally:
        driver.shutdown()


def test_rank_assignment_groups_by_host_hash():
    """Multi-host assignment without remote hosts: tasks under synthetic
    host hashes get consecutive local ranks a host, hosts in hash order,
    and rank 0's registered port for the store; the reference's driver
    assigns the same registrations identically."""
    got = _assign(SparkDriverService, DriverClient, make_secret_key())
    want = _assign(JDriverService, JDriverClient, jmake_secret_key())
    assert got == want
    a0, a1, a2, a3 = (got[i] for i in range(4))
    assert (a0["rank"], a0["local_rank"], a0["cross_rank"]) == (0, 0, 0)
    assert (a1["rank"], a1["local_rank"], a1["cross_rank"]) == (1, 1, 0)
    assert (a2["rank"], a2["local_rank"], a2["cross_rank"]) == (2, 0, 1)
    assert (a3["rank"], a3["local_rank"], a3["cross_rank"]) == (3, 1, 1)
    assert all(a["local_size"] == 2 and a["cross_size"] == 2
               for a in got.values())
    assert all(a["coordinator"].endswith(":1000") for a in got.values())
    assert len({a["coordinator"] for a in got.values()}) == 1


def test_run_local_backend_with_collectives():
    """Spark ranks running the port: ``hvd.init(device="cpu")`` over the
    store rank 0's task hosts, a sum and an average of seeded tensors
    through the eager engine, equal to numpy's exactly."""
    rng = np.random.default_rng(11)
    inputs = [rng.integers(-9, 10, (3, 2)).astype(np.float32)
              for _ in range(2)]

    def torch_collective_fn(inputs):
        import torch
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        rank = hvd.rank()
        x = torch.from_numpy(inputs[rank])
        summed = hvd.allreduce(x, average=False, name="spark.sum")
        mean = hvd.allreduce(x, name="spark.mean")
        hvd.shutdown()
        return rank, summed.numpy(), mean.numpy()

    results = hvd_spark.run(torch_collective_fn, args=(inputs,),
                            num_proc=2, backend="local", start_timeout=120)
    assert [r for r, _, _ in results] == [0, 1]
    for _, summed, mean in results:
        np.testing.assert_array_equal(summed, inputs[0] + inputs[1])
        np.testing.assert_array_equal(mean, (inputs[0] + inputs[1]) / 2)


def test_run_detects_dead_task_process():
    """A rank that dies without reporting must not hang run()."""
    def dying_fn():
        import os
        if int(os.environ["HOROVOD_RANK"]) == 0:
            os._exit(11)  # no TaskFailed message, no result
        return "ok"

    with pytest.raises(RuntimeError, match="died before all ranks"):
        hvd_spark.run(dying_fn, num_proc=2, backend="local",
                      start_timeout=60)


def test_start_timeout_comes_from_the_config(monkeypatch):
    """HOROVOD_SPARK_START_TIMEOUT (Config.spark_start_timeout) bounds
    the wait for the tasks' registration when run() is given none."""
    from horovod_tpu_torch.config import Config
    monkeypatch.setenv("HOROVOD_SPARK_START_TIMEOUT", "17")
    assert Config.from_env().spark_start_timeout == 17
    seen = {}

    def spy(self, timeout, message=None):
        seen["timeout"] = timeout
        raise TimeoutError(message.format(timeout=timeout))

    monkeypatch.setattr(SparkDriverService,
                        "wait_for_initial_registration", spy)
    with pytest.raises(TimeoutError, match="Timed out waiting for 17"):
        hvd_spark.run(_make_rank_env_fn(), num_proc=1, backend="local")
    assert seen == {"timeout": 17}
