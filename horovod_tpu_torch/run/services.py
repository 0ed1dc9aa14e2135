"""Driver/task services for multi-host launches.

Reference equivalents:
- ``BasicDriverService`` (run/common/service/driver_service.py:44) — task
  registration, task-to-task address exchange, host-hash bookkeeping;
- ``BasicTaskService`` (run/common/service/task_service.py) — runs commands
  on the remote host, streams output, watches for termination;
- ``host_hash`` node identity (run/common/util/host_hash.py).

Counterpart of horovod_tpu/run/services.py. The reference needed these
only to bootstrap ``mpirun`` (NIC ring probe + orted spawn). Here they
ARE the launch path for remote hosts (and for local ones under
``HOROVOD_LAUNCH_RPC``): the launcher ssh-bootstraps one
:class:`TaskService` per host (``python -m
horovod_tpu_torch.run.task_fn``), then dispatches one rank command
per slot over authenticated RPC; stdout rides back to the driver as
:class:`OutputChunk` messages and exit codes as :class:`CommandExited`, so
job teardown and per-rank tagged output keep mpirun semantics without MPI.
"""

import hashlib
import os
import signal
import socket
import subprocess
import threading
import time

from .rpc import AckResponse, BasicClient, BasicService, Timeout


def host_hash():
    """Stable node identity (reference: host_hash.py — md5 of hostname)."""
    return hashlib.md5(socket.gethostname().encode()).hexdigest()


# ---------------------------------------------------------------- messages

class RegisterTaskRequest:
    def __init__(self, index, task_addresses, hosthash):
        self.index = index
        self.task_addresses = task_addresses
        self.hosthash = hosthash


class AllTaskAddressesRequest:
    def __init__(self, index):
        self.index = index


class AllTaskAddressesResponse:
    def __init__(self, all_task_addresses):
        self.all_task_addresses = all_task_addresses


class TaskHostHashIndicesRequest:
    pass


class TaskHostHashIndicesResponse:
    def __init__(self, task_host_hash_indices):
        self.task_host_hash_indices = task_host_hash_indices


class OutputChunk:
    def __init__(self, rank, stream, text):
        self.rank = rank
        self.stream = stream  # "stdout" | "stderr"
        self.text = text


class CommandExited:
    def __init__(self, rank, exit_code):
        self.rank = rank
        self.exit_code = exit_code


class RunCommandRequest:
    def __init__(self, rank, command, env):
        self.rank = rank
        self.command = command  # argv list or shell string
        self.env = env


class FreePortRequest:
    """Ask a task service for a port that is free on ITS host (used for the
    job's store, which rank 0 hosts on the first job host — the launcher
    machine's port space is irrelevant there)."""


class FreePortResponse:
    def __init__(self, port):
        self.port = port


class TerminateRequest:
    pass


# ---------------------------------------------------------------- services

class DriverService(BasicService):
    """Collects task registrations and per-rank command results.

    Reference: driver_service.py:44 — ``wait_for_initial_registration``,
    task address exchange, host-hash ordering (used by Spark to build the
    ``-H`` list; spark/__init__.py:160-171).
    """

    NAME = "driver service"

    def __init__(self, num_hosts, key):
        super().__init__(self.NAME, key)
        self._num_hosts = num_hosts
        self._task_addresses = {}
        self._task_host_hashes = {}
        self._exit_codes = {}
        self._wait_cond = threading.Condition()
        self._output_sink = None  # callable(OutputChunk) or None

    def set_output_sink(self, sink):
        self._output_sink = sink

    def _handle(self, req, client_address):
        if isinstance(req, RegisterTaskRequest):
            addrs = list(req.task_addresses)
            # Prefer the source IP this registration actually arrived from:
            # it is a proven-routable path to the task's host, unlike
            # self-reported interface addresses which may be unreachable
            # (tunnels, TEST-NET, downed NICs). The reference solves the
            # same problem with its NIC ring probe (run/run.py:187-256);
            # the registration round-trip is our probe. Services bind
            # 0.0.0.0, so the observed IP works with the common port.
            observed = client_address[0] if client_address else None
            if observed and (observed.startswith("127.")
                             or observed == "::1"):
                # loopback proves nothing about peer routability (the
                # driver may share a host with this task); leave the
                # self-reported order alone
                observed = None
            if observed and addrs:
                if observed in [ip for ip, _ in addrs]:
                    # already reported: just move it to the front
                    addrs.sort(key=lambda a: a[0] != observed)
                else:
                    # not reported: pair the proven-routable IP with each
                    # distinct reported port (mixed ports included — the
                    # sort would be a no-op there and the observed address
                    # must not be silently dropped)
                    addrs[:0] = [(observed, port) for port in
                                 dict.fromkeys(p for _, p in addrs)]
            with self._wait_cond:
                self._task_addresses[req.index] = addrs
                self._task_host_hashes[req.index] = req.hosthash
                self._wait_cond.notify_all()
            return AckResponse()
        if isinstance(req, AllTaskAddressesRequest):
            return AllTaskAddressesResponse(
                self._task_addresses.get(req.index))
        if isinstance(req, TaskHostHashIndicesRequest):
            return TaskHostHashIndicesResponse(
                self.task_host_hash_indices())
        if isinstance(req, OutputChunk):
            sink = self._output_sink
            if sink is not None:
                sink(req)
            return AckResponse()
        if isinstance(req, CommandExited):
            with self._wait_cond:
                self._exit_codes[req.rank] = req.exit_code
                self._wait_cond.notify_all()
            return AckResponse()
        return super()._handle(req, client_address)

    DEFAULT_TIMEOUT_MESSAGE = (
        "Horovodrun was unable to start all processes within {timeout} "
        "seconds. Consider increasing the --start-timeout parameter or "
        "the HOROVOD_START_TIMEOUT environment variable.")

    def wait_for_initial_registration(self, timeout, message=None):
        """Block until every host's task service registered.

        Timeout message parity with the reference launcher
        (run/run.py:359-376 / HOROVOD_START_TIMEOUT); Spark passes its own
        wording.
        """
        tmout = Timeout(timeout, message or self.DEFAULT_TIMEOUT_MESSAGE)
        with self._wait_cond:
            while len(self._task_addresses) < self._num_hosts:
                self._wait_cond.wait(min(1.0, tmout.remaining() + 0.01))
                tmout.check()

    def task_addresses_for(self, index):
        return self._task_addresses.get(index)

    def task_host_hash_indices(self):
        indices = {}
        with self._wait_cond:
            for idx, hh in sorted(self._task_host_hashes.items()):
                indices.setdefault(hh, []).append(idx)
        return indices

    def wait_for_exit_codes(self, ranks, poll=0.1):
        with self._wait_cond:
            while not all(r in self._exit_codes for r in ranks):
                self._wait_cond.wait(poll)
            return dict(self._exit_codes)

    def exit_codes(self):
        with self._wait_cond:
            return dict(self._exit_codes)


class DriverClient(BasicClient):
    def __init__(self, addresses, key):
        super().__init__(DriverService.NAME, addresses, key)

    def register_task(self, index, task_addresses, hosthash):
        self.request(RegisterTaskRequest(index, task_addresses, hosthash))

    def all_task_addresses(self, index):
        return self.request(AllTaskAddressesRequest(index)).all_task_addresses

    def task_host_hash_indices(self):
        return self.request(
            TaskHostHashIndicesRequest()).task_host_hash_indices

    def send_output(self, rank, stream, text):
        self.request(OutputChunk(rank, stream, text))

    def command_exited(self, rank, exit_code):
        self.request(CommandExited(rank, exit_code))


class TaskService(BasicService):
    """Runs rank commands on this host, streaming output to the driver.

    Reference: task_service.py — ``RunCommandRequest`` execs via
    safe_shell_exec (process-group kill on termination); here each command
    runs in its own session so :class:`TerminateRequest` can kill the whole
    tree, and stdout/stderr pump threads forward lines to the driver.
    """

    NAME = "task service"

    def __init__(self, index, key, driver_client, drain_seconds=None):
        super().__init__(self.NAME, key)
        self._index = index
        self._driver = driver_client
        self._procs = []
        self._lock = threading.Lock()
        self._terminated = threading.Event()
        # SIGTERM -> SIGKILL escalation deadline. Env-configurable so a
        # preemption-grace window (HOROVOD_ELASTIC_GRACE_SECONDS) is not
        # cut short by a hardcoded 3s teardown: workers get drain time
        # to commit before the hard kill.
        if drain_seconds is None:
            from ..config import Config
            drain_seconds = Config.from_env().elastic_drain_seconds
        self._drain_seconds = max(float(drain_seconds), 0.0)

    def _handle(self, req, client_address):
        if isinstance(req, RunCommandRequest):
            self._run_command(req)
            return AckResponse()
        if isinstance(req, FreePortRequest):
            with socket.socket() as s:
                s.bind(("", 0))
                return FreePortResponse(s.getsockname()[1])
        if isinstance(req, TerminateRequest):
            self.terminate()
            return AckResponse()
        return super()._handle(req, client_address)

    def _run_command(self, req):
        shell = isinstance(req.command, str)
        # Rank env rides on top of the host environment (the reference
        # exports selected vars through mpirun -x the same way).
        env = dict(os.environ)
        env.update(req.env or {})
        proc = subprocess.Popen(
            req.command, shell=shell, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            start_new_session=True)
        with self._lock:
            self._procs.append(proc)

        def pump(stream, name):
            for line in iter(stream.readline, b""):
                try:
                    self._driver.send_output(
                        req.rank, name, line.decode(errors="replace"))
                except ConnectionError:
                    break
            stream.close()

        pumps = [threading.Thread(target=pump, args=(proc.stdout, "stdout"),
                                  daemon=True),
                 threading.Thread(target=pump, args=(proc.stderr, "stderr"),
                                  daemon=True)]
        for t in pumps:
            t.start()

        def wait():
            rc = proc.wait()
            for t in pumps:
                t.join(timeout=5)
            try:
                self._driver.command_exited(req.rank, rc)
            except ConnectionError:
                pass

        threading.Thread(target=wait, daemon=True).start()

    def terminate(self):
        with self._lock:
            procs = list(self._procs)
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        deadline = time.time() + self._drain_seconds
        for p in procs:
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        self._terminated.set()

    def wait_for_termination(self, timeout=None):
        """True once terminated; False on timeout (lets the task_fn idle
        loop interleave driver-liveness pings)."""
        return self._terminated.wait(timeout)


class TaskClient(BasicClient):
    def __init__(self, addresses, key):
        super().__init__(TaskService.NAME, addresses, key)

    def run_command(self, rank, command, env):
        # Not idempotent: a retry could spawn the rank twice.
        self.request(RunCommandRequest(rank, command, env),
                     idempotent=False)

    def free_port(self):
        return self.request(FreePortRequest()).port

    def terminate(self):
        self.request(TerminateRequest())
