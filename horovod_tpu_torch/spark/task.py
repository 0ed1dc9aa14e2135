"""Spark task side: register, receive a rank, run the user function.

Counterpart of horovod_tpu/spark/task.py (upstream: the ``_task_fn``
each Spark task runs, spark/__init__.py:29-61, and ``mpirun_exec_fn.py``):
the task registers an address where it could host the job's store,
polls for its rank assignment, sets the launcher's variables, runs the
function and sends the result (or its error) back to the driver.
"""

import base64
import os
import socket
import sys
import time

from ..run.rpc import dumps_base64, local_addresses
from ..run.services import DriverClient, host_hash
from .driver import (RankAssignmentRequest, ResultMessage, TaskFailed)


def _reserve_port():
    """A port free on this host, for the job's store in case this task
    becomes rank 0."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _wire_env(a):
    env = {
        "HOROVOD_TPU_COORDINATOR": a.coordinator,
        "HOROVOD_TPU_NUM_PROCESSES": str(a.size),
        "HOROVOD_TPU_PROCESS_ID": str(a.rank),
        "HOROVOD_TPU_LOCAL_RANK": str(a.local_rank),
        "HOROVOD_TPU_LOCAL_SIZE": str(a.local_size),
        "HOROVOD_TPU_CROSS_RANK": str(a.cross_rank),
        "HOROVOD_TPU_CROSS_SIZE": str(a.cross_size),
        "HOROVOD_RANK": str(a.rank),
        "HOROVOD_SIZE": str(a.size),
        "HOROVOD_LOCAL_RANK": str(a.local_rank),
        "HOROVOD_LOCAL_SIZE": str(a.local_size),
    }
    os.environ.update(env)


def task_fn(index, driver_addr_arg, secret_b64, payload_b64, extra_env):
    """Executed inside the Spark task (or the local-backend process)."""
    from ..run.rpc import loads_base64
    from ..run.task_fn import _parse_addresses

    key = base64.b64decode(secret_b64)
    driver = DriverClient(_parse_addresses(driver_addr_arg), key)
    port = _reserve_port()
    # Register a reachable (ip, port): first non-loopback interface, the
    # upstream NIC-probe outcome without the ring probe (the driver
    # address already proves connectivity).
    ip = local_addresses()[0]
    driver.register_task(index, [(ip, port)], host_hash())

    assignment = None
    while assignment is None:
        assignment = driver.request(RankAssignmentRequest(index)).assignment
        if assignment is None:
            time.sleep(0.1)

    os.environ.update(extra_env or {})
    _wire_env(assignment)
    try:
        fn, args, kwargs = loads_base64(payload_b64)
        result = fn(*args, **kwargs)
        driver.request(ResultMessage(assignment.rank, dumps_base64(result)))
        return assignment.rank
    except Exception as e:  # noqa: BLE001 — report, then re-raise
        try:
            driver.request(TaskFailed(index, f"{type(e).__name__}: {e}"))
        finally:
            raise


def main():
    if len(sys.argv) != 3:
        print("usage: python -m horovod_tpu_torch.spark.task <index> "
              "<driver_host:port[,...]>  (secret b64 + payload b64 on "
              "stdin)", file=sys.stderr)
        return 1
    index = int(sys.argv[1])
    addr_arg = sys.argv[2]
    secret_b64 = sys.stdin.readline().strip()
    payload_b64 = sys.stdin.readline().strip()
    task_fn(index, addr_arg, secret_b64, payload_b64, {})
    return 0


if __name__ == "__main__":
    sys.exit(main())
