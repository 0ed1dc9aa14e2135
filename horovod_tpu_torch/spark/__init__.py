"""``horovod_tpu_torch.spark.run(fn, ...)``: Spark cluster integration.

Counterpart of horovod_tpu/spark/ (upstream: horovod/spark/__init__.py
:92-227). The Spark task is the rank: each task registers its host hash
and an address where it could host the job's store with the
:class:`~horovod_tpu_torch.spark.driver.SparkDriverService`, the driver
assigns ranks as upstream builds its ``-H`` list (tasks grouped by
host hash, consecutive local ranks a host), every task sets the
launcher's variables (``HOROVOD_TPU_COORDINATOR`` is rank 0's address,
where ``hvd.init()`` puts the job's TCPStore) and calls the pickled user
function in its own process; the results come back in rank order.

The driver and task protocol runs over the port's ``run/`` (``rpc.py``,
``services.py``) under two backends:

- ``spark`` (default): ``sc.range(num_proc).mapPartitionsWithIndex``;
  needs pyspark (an ImportError in upstream's words without it);
- ``local``: one spawned process a rank, for a single host without
  Spark and for the tests.

The user function runs torch and the port: a rank on a card calls
``hvd.init()`` (NCCL, one card a rank), ranks sharing a card or the CPU
pass their own gloo group or ``device="cpu"``, as with the launcher.
"""

import os
import subprocess
import sys
import threading

from ..run.rpc import dumps_base64, make_secret_key
from .driver import SparkDriverService

__all__ = ["run"]


def _spark_job(driver, num_proc, payload_b64, secret_b64, start_timeout,
               env, verbose):
    """Run the Spark job that hosts the ranks (upstream:
    spark/__init__.py:70-89 — background job over num_proc tasks)."""
    import pyspark

    sc = pyspark.SparkContext._active_spark_context
    if sc is None:
        raise RuntimeError(
            "No active SparkContext; horovod_tpu_torch.spark.run() must be "
            "called from a Spark driver program.")
    addr_arg = ",".join(f"{ip}:{port}" for ip, port in driver.addresses())

    def mapper(index, _iterator):
        from horovod_tpu_torch.spark.task import task_fn
        yield task_fn(index, addr_arg, secret_b64, payload_b64,
                      env or {})

    state = {"error": None, "done": False}
    job_group = f"horovod_tpu_torch.spark.{os.getpid()}.{id(driver)}"

    def body():
        try:
            # Own job group so teardown can cancel pending task retries —
            # Spark would otherwise re-run a failed rank's user fn (with
            # its side effects) against an already-dead driver.
            sc.setJobGroup(job_group, "horovod_tpu_torch.spark.run",
                           interruptOnCancel=True)
            sc.range(0, num_proc, numSlices=num_proc) \
              .mapPartitionsWithIndex(mapper).collect()
        except Exception as e:  # noqa: BLE001 — surfaced via failed()
            state["error"] = f"{type(e).__name__}: {e}"
        finally:
            state["done"] = True

    thread = threading.Thread(target=body, daemon=True)
    thread.start()

    class _SparkJob:
        def join(self, timeout=None):
            thread.join(timeout)

        def kill(self):
            try:
                sc.cancelJobGroup(job_group)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

        def failed(self):
            """Error string if the job died before delivering results."""
            return state["error"] if state["done"] else None

    return _SparkJob()


def _local_job(driver, num_proc, payload_b64, secret_b64, start_timeout,
               env, verbose):
    """Local backend: one spawned process per rank (the payload and secret
    ride stdin, never argv)."""
    addr_arg = ",".join(f"{ip}:{port}" for ip, port in driver.addresses())
    procs = []
    for index in range(num_proc):
        benv = dict(os.environ)
        benv.update(env or {})
        p = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.spark.task",
             str(index), addr_arg],
            env=benv, stdin=subprocess.PIPE, start_new_session=True)
        p.stdin.write((secret_b64 + "\n" + payload_b64 + "\n").encode())
        p.stdin.flush()
        p.stdin.close()
        procs.append(p)

    class _Waiter:
        def join(self, timeout=None):
            for p in procs:
                try:
                    p.wait(timeout)
                except subprocess.TimeoutExpired:
                    pass

        def kill(self):
            for p in procs:
                if p.poll() is None:
                    p.kill()

        def failed(self):
            """Error string if a rank process died abnormally."""
            dead = [(i, p.returncode) for i, p in enumerate(procs)
                    if p.poll() is not None and p.returncode != 0]
            if dead:
                idx, rc = dead[0]
                return f"task process {idx} exited with code {rc}"
            return None

    return _Waiter()


def run(fn, args=(), kwargs=None, num_proc=None, start_timeout=None,
        env=None, verbose=1, backend="spark"):
    """Run ``fn(*args, **kwargs)`` on ``num_proc`` ranks; returns the list
    of results ordered by rank (upstream: spark/__init__.py:92,222-227).

    ``start_timeout`` defaults to HOROVOD_SPARK_START_TIMEOUT (then 600s),
    matching upstream's on-demand-cluster allowance.
    """
    import base64

    if backend not in ("spark", "local"):
        raise ValueError(
            f"unknown backend {backend!r}; expected 'spark' or 'local'")
    if backend == "spark":
        try:
            import pyspark
        except ImportError as e:
            raise ImportError(
                "horovod_tpu_torch.spark.run() with backend='spark' requires "
                "pyspark to be installed on the Spark driver. Use "
                "backend='local' for a single-host run without Spark."
            ) from e
        if num_proc is None:
            sc = pyspark.SparkContext._active_spark_context
            num_proc = sc.defaultParallelism if sc else None
    if num_proc is None or num_proc < 1:
        raise ValueError("num_proc must be a positive integer.")
    if start_timeout is None:
        from ..config import Config
        start_timeout = Config.from_env().spark_start_timeout

    key = make_secret_key()
    secret_b64 = base64.b64encode(key).decode("ascii")
    payload_b64 = dumps_base64((fn, tuple(args), dict(kwargs or {})))

    driver = SparkDriverService(num_proc=num_proc, key=key)
    job = None
    try:
        starter = _spark_job if backend == "spark" else _local_job
        job = starter(driver, num_proc, payload_b64, secret_b64,
                      start_timeout, env, verbose)
        driver.wait_for_initial_registration(
            start_timeout,
            message=(
                "Timed out waiting for {timeout} seconds. Please check "
                "that you have enough resources to run all Horovod "
                "processes. Each Horovod process runs in a Spark task. "
                "You may need to increase the start_timeout parameter to "
                "a larger value if your Spark resources are allocated "
                "on-demand."))
        driver.compute_assignments()
        results = driver.wait_for_results(liveness=job.failed)
        return [results[r] for r in range(num_proc)]
    finally:
        if job is not None:
            job.join(timeout=10)
            job.kill()  # any survivors (e.g. after a task failure)
        driver.shutdown()
