"""Spark driver service: rank assignment and rank-ordered results.

Counterpart of horovod_tpu/spark/driver.py (upstream:
horovod/spark/driver/driver_service.py, the ``SparkDriverService``
collecting host hashes and task addresses, and the result queue of
spark/__init__.py:222-227). Upstream turns the host hashes into an
mpirun ``-H hosthash:count`` list (spark/__init__.py:160-171); here the
same grouping is the rank assignment.
"""

import threading
import time

from ..run.services import DriverService


class RankAssignment:
    def __init__(self, rank, size, local_rank, local_size, cross_rank,
                 cross_size, coordinator):
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size
        self.coordinator = coordinator  # "host:port" of the job's store


class RankAssignmentRequest:
    def __init__(self, index):
        self.index = index


class RankAssignmentResponse:
    def __init__(self, assignment):
        self.assignment = assignment  # RankAssignment | None (not ready)


class ResultMessage:
    def __init__(self, rank, result_b64):
        self.rank = rank
        self.result_b64 = result_b64


class TaskFailed:
    def __init__(self, index, error):
        self.index = index
        self.error = error


class SparkDriverService(DriverService):
    """num_hosts == num_proc: every Spark task registers itself."""

    NAME = "driver service"  # tasks reuse DriverClient (same service name)

    def __init__(self, num_proc, key):
        super().__init__(num_hosts=num_proc, key=key)
        self._num_proc = num_proc
        self._assignments = None
        self._results = {}
        self._failure = None
        self._result_cond = threading.Condition()

    def _handle(self, req, client_address):
        if isinstance(req, RankAssignmentRequest):
            with self._result_cond:
                a = (self._assignments or {}).get(req.index)
            return RankAssignmentResponse(a)
        if isinstance(req, ResultMessage):
            from ..run.rpc import AckResponse
            with self._result_cond:
                self._results[req.rank] = req.result_b64
                self._result_cond.notify_all()
            return AckResponse()
        if isinstance(req, TaskFailed):
            from ..run.rpc import AckResponse
            with self._result_cond:
                self._failure = (req.index, req.error)
                self._result_cond.notify_all()
            return AckResponse()
        return super()._handle(req, client_address)

    def compute_assignments(self):
        """Group registered tasks by host hash — consecutive local ranks
        per host, host order by hash (upstream -H list construction:
        spark/__init__.py:160-171)."""
        indices_by_host = self.task_host_hash_indices()  # {hash: [indices]}
        hosts = sorted(indices_by_host)
        assignments = {}
        rank = 0
        rank0_index = None
        for cross_rank, hh in enumerate(hosts):
            members = sorted(indices_by_host[hh])
            for local_rank, index in enumerate(members):
                if rank == 0:
                    rank0_index = index
                assignments[index] = RankAssignment(
                    rank=rank, size=self._num_proc,
                    local_rank=local_rank, local_size=len(members),
                    cross_rank=cross_rank, cross_size=len(hosts),
                    coordinator=None)
                rank += 1
        # Coordinator: rank 0's registered (ip, port) — the port the task
        # reserved in its own host's port space. The coordinator must be
        # routable from EVERY rank: on a single-host job loopback is the
        # one address guaranteed reachable (self-reported NICs may be
        # tunnels/TEST-NET); multi-host, loopback is guaranteed wrong.
        addrs = self.task_addresses_for(rank0_index)

        def loop(a):
            return a[0].startswith("127.") or a[0] == "::1"

        if len(hosts) == 1:
            # tasks self-report NIC addresses, not loopback — substitute it
            ip, port = "127.0.0.1", addrs[0][1]
        else:
            preferred = [a for a in addrs if not loop(a)]
            ip, port = (preferred or addrs)[0]
        coordinator = f"{ip}:{port}"
        for a in assignments.values():
            a.coordinator = coordinator
        with self._result_cond:
            self._assignments = assignments
        return assignments

    def wait_for_results(self, timeout=None, liveness=None):
        """Block until every rank reported; raise if any task failed
        (upstream: results queue drained rank-ordered,
        spark/__init__.py:222-227).

        ``liveness``: optional zero-arg callable returning an error string
        when the backing job died without reporting (a crashed rank
        process / lost executor would otherwise hang this wait forever).
        """
        from ..run.rpc import loads_base64
        deadline = None if timeout is None else time.time() + timeout
        with self._result_cond:
            while (len(self._results) < self._num_proc
                   and self._failure is None):
                job_error = liveness() if liveness is not None else None
                if job_error is not None:
                    raise RuntimeError(
                        f"Horovod Spark job died before all ranks "
                        f"reported results: {job_error}")
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError(
                        "Timed out waiting for Spark task results.")
                self._result_cond.wait(timeout=1.0)
            if self._failure is not None:
                index, error = self._failure
                raise RuntimeError(
                    f"Horovod Spark task {index} failed: {error}")
            return {r: loads_base64(b) for r, b in self._results.items()}
