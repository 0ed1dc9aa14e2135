"""``horovodrun``-equivalent launcher — one process per slot, no MPI.

Counterpart of horovod_tpu/run/run.py. Reference equivalent:
horovod/run/run.py — the ``horovodrun -np N -H host:slots cmd`` CLI
(:285-343) that SSH-checks hosts, ring-probes NICs, and finally execs
``mpirun`` (:446-486).

There is no mpirun. The launcher spawns one process per slot directly:

- **local slots**: plain subprocesses;
- **remote hosts** (``-H host:slots``): ``ssh host env ... cmd`` per slot,
  or, through the driver and task services (run/services.py), one task
  service per host (always for remote hosts through ``launch``, and for
  local ones under ``HOROVOD_LAUNCH_RPC=1``);
- rank discovery flows through environment variables
  (``HOROVOD_TPU_PROCESS_ID`` etc.) that :mod:`horovod_tpu_torch.runtime`
  reads: ``init()`` joins the job's ``TCPStore`` at
  ``HOROVOD_TPU_COORDINATOR``, which rank 0 hosts, and builds its process
  group over it. The coordinator address is explicit, so there is no NIC
  ring probe.

The launcher picks no device and no backend: ``init()`` maps
``HOROVOD_TPU_LOCAL_RANK`` to ``cuda:<local_rank>`` and takes NCCL there
(gloo on ``device="cpu"``); a worker that shares one card with another
builds its own gloo group first, which ``init()`` adopts.

Behavior parity kept: the CLI flags (-np, -H, -p/--ssh-port,
--start-timeout, --verbose, --disable-cache accepted), the
``HOROVOD_START_TIMEOUT`` env override and its error message style
(reference: run/run.py:359-376), per-rank prefixed output streaming, and
whole-job teardown when any rank fails (mpirun semantics).
"""

import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time

from .. import __version__


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Horovod Runner "
                                     "(horovod_tpu_torch)")
    parser.add_argument("-v", "--version", action="store_true",
                        dest="version",
                        help="Shows horovod_tpu_torch version.")
    parser.add_argument("-np", "--num-proc", action="store", dest="np",
                        type=int,
                        help="Total number of training processes.")
    parser.add_argument("-p", "--ssh-port", action="store", dest="ssh_port",
                        type=int, help="SSH port on all the hosts.")
    parser.add_argument("-H", "--host", action="store", dest="host",
                        help="List of host names and the number of slots on "
                             "each, e.g. host1:2,host2:4. Default: all "
                             "slots on localhost.")
    parser.add_argument("--disable-cache", action="store_true",
                        dest="disable_cache",
                        help="Re-run the SSH host checks instead of using "
                             "results cached in ~/.horovod_tpu_torch (cached "
                             "results go stale after 60 minutes).")
    parser.add_argument("--start-timeout", action="store",
                        dest="start_timeout", type=int,
                        help="All processes must start before this timeout "
                             "(default 30s; HOROVOD_START_TIMEOUT env also "
                             "accepted).")
    parser.add_argument("--verbose", action="store_true", dest="verbose")
    parser.add_argument("--max-restarts", action="store", type=int,
                        dest="max_restarts", default=None,
                        help="Relaunch the whole job up to N times after a "
                             "failed run (gang restart: every rank "
                             "restarts and resumes from its checkpoint, "
                             "e.g. via horovod_tpu_torch.checkpoint."
                             "CheckpointManager). "
                             "Default 0 (fail fast, mpirun semantics); "
                             "HOROVOD_MAX_RESTARTS env also accepted. With "
                             "--elastic this bounds PER-WORKER restarts "
                             "instead (default 3).")
    parser.add_argument("--elastic", action="store_true", dest="elastic",
                        help="Supervise workers individually instead of "
                             "mpirun's first-failure-kills-the-job: a "
                             "transiently-failed worker (signal-killed, "
                             "e.g. preempted) is restarted with "
                             "exponential backoff, and the job continues "
                             "while at least --min-workers remain. Pairs "
                             "with HOROVOD_ELASTIC=1 in-job recovery "
                             "(horovod_tpu_torch.elastic).")
    parser.add_argument("--min-workers", action="store", type=int,
                        dest="min_workers", default=1,
                        help="Elastic: tear the job down when fewer than "
                             "this many workers remain (default 1).")
    parser.add_argument("--max-workers", action="store", type=int,
                        dest="max_workers", default=None,
                        help="Elastic: cap on concurrently running "
                             "workers (default -np).")
    parser.add_argument("--autoscale", action="store_true",
                        dest="autoscale",
                        help="Elastic: drive the world size from live "
                             "traffic signals (straggler skew, input "
                             "stall, prefetch occupancy) between "
                             "--min-workers and --max-workers. Scale-"
                             "downs drain one worker gracefully "
                             "(requires HOROVOD_ELASTIC_GRACE_SECONDS "
                             "> 0); scale-ups relaunch the gang at the "
                             "new size from grace snapshots.")
    parser.add_argument("--policy-interval", action="store", type=float,
                        dest="policy_interval", default=5.0,
                        help="Autoscale: seconds between policy "
                             "evaluations (default 5).")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="Command to be executed.")
    args = parser.parse_args(argv)
    if not args.version and not args.np:
        parser.error("argument -np/--num-proc is required")
    return args


def _parse_hosts(host_arg, np_):
    """-H host1:2,host2:4 -> [(host, slots)] covering np ranks
    (reference format: run/run.py:303-305)."""
    if not host_arg:
        return [("localhost", np_)]
    hosts = []
    for item in host_arg.split(","):
        name, _, slots = item.partition(":")
        hosts.append((name.strip(), int(slots) if slots else 1))
    total = sum(s for _, s in hosts)
    if total < np_:
        raise ValueError(
            f"Host slots ({total}) < number of processes ({np_}). "
            f"Add more hosts or slots.")
    return hosts


def _job_code(codes):
    """Aggregate rank exit codes: 0 only when every rank exited 0.
    Signal-killed ranks report negative codes (-signum) — those must
    count as failure (and map to 1 for the shell) even when another rank
    exited 0, or max() would call the job clean."""
    codes = list(codes)
    if not codes:
        return 1
    bad = [c for c in codes if c != 0]
    if not bad:
        return 0
    pos = [c for c in bad if c > 0]
    return max(pos) if pos else 1


def _print_job_summary(codes, file=None):
    """Per-rank failure summary: a signal-killed worker (negative
    returncode — preemption, the OOM killer, a node drain) reads
    distinctly from a Python-error exit, so the operator knows whether to
    fix code or infrastructure. ``codes``: rank -> exit code mapping or a
    sequence indexed by rank."""
    from ..elastic.supervisor import describe_exit
    file = file if file is not None else sys.stderr
    items = (sorted(codes.items()) if isinstance(codes, dict)
             else enumerate(codes))
    for rank, code in items:
        if code not in (0, None):
            print(f"horovodrun: rank {rank} {describe_exit(code)}",
                  file=file)


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _terminate_all(procs, sig=signal.SIGTERM, escalate_after=None):
    """Kill every still-running rank's process group (mpirun-style whole
    job teardown; every rank is started in its own session).

    With ``escalate_after`` set, a SIGTERM is given that many seconds to
    drain — workers on the preemption-grace path
    (HOROVOD_ELASTIC_GRACE_SECONDS) use it to commit and depart — before
    any survivor's process group is SIGKILLed. Without it the behavior
    is the historical fire-and-forget."""
    values = list(procs.values() if isinstance(procs, dict) else procs)
    for p in values:
        if p.poll() is None:
            try:
                os.killpg(p.pid, sig)
            except ProcessLookupError:
                pass
    if escalate_after is None or sig == signal.SIGKILL:
        return
    deadline = time.time() + escalate_after
    while time.time() < deadline and any(p.poll() is None for p in values):
        time.sleep(0.05)
    for p in values:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _drain_window(base_env):
    """Grace + escalation allowance for a graceful teardown, from the
    same env the workers read (config.py): a worker gets its full grace
    window plus the drain margin before the hard kill."""
    def _f(name, default):
        try:
            return float(base_env.get(name, "") or default)
        except ValueError:
            return default
    return _f("HOROVOD_ELASTIC_GRACE_SECONDS", 0.0) + \
        _f("HOROVOD_ELASTIC_DRAIN_SECONDS", 3.0)


def _forward_sigterm():
    """Install a launcher-level SIGTERM flag (main thread only — under
    pytest or an embedding app the handler install is skipped and the
    flag simply never trips). Cluster preemption of horovodrun itself
    thereby drains the workers gracefully instead of orphaning them.
    Returns ``(flag_dict, restore_fn)``."""
    flag = {"tripped": False}

    def handler(signum, frame):
        flag["tripped"] = True

    try:
        prev = signal.signal(signal.SIGTERM, handler)
    except ValueError:
        return flag, lambda: None

    def restore():
        try:
            signal.signal(signal.SIGTERM, prev)
        except ValueError:
            pass
    return flag, restore


def _start_timeout_error(start_timeout):
    """The reference's startup-timeout message (run/run.py:359-376
    style), shared by every launch path."""
    return TimeoutError(
        f"Horovodrun was unable to start all processes within "
        f"{start_timeout} seconds. Consider increasing the "
        f"--start-timeout parameter or the HOROVOD_START_TIMEOUT "
        f"environment variable.")


def _rank_env(base_env, coordinator, np_, rank, local_rank, local_size,
              cross_rank, cross_size):
    env = dict(base_env)
    env.update({
        "HOROVOD_TPU_COORDINATOR": coordinator,
        "HOROVOD_TPU_NUM_PROCESSES": str(np_),
        "HOROVOD_TPU_PROCESS_ID": str(rank),
        "HOROVOD_TPU_LOCAL_RANK": str(local_rank),
        "HOROVOD_TPU_LOCAL_SIZE": str(local_size),
        "HOROVOD_TPU_CROSS_RANK": str(cross_rank),
        "HOROVOD_TPU_CROSS_SIZE": str(cross_size),
        # Legacy names many reference-era scripts read:
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(np_),
        "HOROVOD_LOCAL_RANK": str(local_rank),
        "HOROVOD_LOCAL_SIZE": str(local_size),
    })
    return env


def _stream(proc, rank, verbose):
    """Per-rank prefixed output streaming (mpirun-style tagged output)."""
    for line in iter(proc.stdout.readline, b""):
        sys.stdout.write(f"[{rank}]<stdout>: {line.decode(errors='replace')}")
        sys.stdout.flush()


def _placements(host_list, np_):
    """rank -> (host, local_rank, local_size, cross_rank)."""
    placements = []
    for cross_rank, (host, slots) in enumerate(host_list):
        for local_rank in range(slots):
            if len(placements) < np_:
                placements.append((host, local_rank, slots, cross_rank))
    return placements


def _is_local(host):
    return host in ("localhost", "127.0.0.1", socket.gethostname())


SSH_RETRIES = 5
SSH_CONNECT_TIMEOUT = 10  # seconds; -o ConnectTimeout + subprocess bound
SSH_RETRY_DELAY = 0.5     # seconds between failed attempts


def check_all_hosts_ssh_successful(hosts, ssh_port=None, fn_cache=None,
                                   _ssh_exec=None):
    """SSH-reachability pre-check of every remote host, threaded, with the
    launcher result cache (reference: run/run.py:47-102 — same retry count,
    failure message shape, and exit-on-failure behavior; cache keyed per
    host like the reference's fn_cache-wrapped check).

    ``_ssh_exec`` injects the probe command for tests.
    """
    import concurrent.futures

    def probe(host):
        if fn_cache is not None:
            hit = fn_cache.get(("ssh", host, ssh_port))
            if hit is not None:
                return host, 0, ""
        if _ssh_exec is not None:
            code, msg = _ssh_exec(host)
        else:
            port = ["-p", str(ssh_port)] if ssh_port else []
            # Both the ssh-level ConnectTimeout and the subprocess timeout
            # bound a blackholed host (dropped packets, no RST): without
            # them 5 retries could hang the launcher indefinitely, far past
            # start_timeout.
            cmd = ["ssh", "-o", "StrictHostKeyChecking=no",
                   "-o", f"ConnectTimeout={SSH_CONNECT_TIMEOUT}", *port,
                   host, "date"]
            code, msg = 1, ""
            for attempt in range(SSH_RETRIES):
                try:
                    p = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=SSH_CONNECT_TIMEOUT + 5)
                except subprocess.TimeoutExpired:
                    msg = (f"ssh to {host} timed out after "
                           f"{SSH_CONNECT_TIMEOUT + 5}s")
                    continue
                except OSError as e:  # e.g. no ssh binary on PATH
                    msg = str(e)
                    break
                code = p.returncode
                if code == 0:
                    break
                msg = p.stdout + p.stderr
                if attempt + 1 < SSH_RETRIES:
                    time.sleep(SSH_RETRY_DELAY)
        if code == 0 and fn_cache is not None:
            fn_cache.put(("ssh", host, ssh_port), True)
        return host, code, msg

    remote = [h for h in hosts if not _is_local(h)]
    if not remote:
        return True
    with concurrent.futures.ThreadPoolExecutor(len(remote)) as pool:
        results = list(pool.map(probe, remote))
    ok = True
    for host, code, msg in results:
        if code != 0:
            print(f"ssh not successful for host {host}:\n{msg}",
                  file=sys.stderr)
            ok = False
    if not ok:
        raise RuntimeError(
            "SSH was not successful for all hosts; see the per-host "
            "output above.")
    return True


def launch_via_services(np_, command, host_list, ssh_port=None,
                        start_timeout=30, verbose=False, env=None):
    """RPC launch path: one TaskService per host, one command per slot.

    This is the reference's driver/task-service architecture
    (run/common/service/) promoted from mpirun bootstrap helper to the
    actual launch mechanism: the driver ssh-bootstraps
    ``python -m horovod_tpu_torch.run.task_fn`` once per host, each task service
    registers back, then rank commands are dispatched over authenticated
    RPC with output and exit codes streamed to the driver.
    """
    import base64

    from .rpc import make_secret_key
    from .services import DriverService, TaskClient

    base_env = dict(env if env is not None else os.environ)
    key = make_secret_key()
    driver = DriverService(num_hosts=len(host_list), key=key)

    def sink(chunk):
        out = sys.stdout if chunk.stream == "stdout" else sys.stderr
        out.write(f"[{chunk.rank}]<{chunk.stream}>: {chunk.text}")
        out.flush()

    driver.set_output_sink(sink)
    addr_arg = ",".join(f"{ip}:{port}" for ip, port in driver.addresses())
    secret_b64 = base64.b64encode(key).decode("ascii")

    bootstraps = []
    clients = None
    try:
        for index, (host, _slots) in enumerate(host_list):
            boot = [sys.executable, "-m", "horovod_tpu_torch.run.task_fn",
                    str(index), addr_arg]
            if _is_local(host):
                cmd, benv = boot, dict(base_env)
            else:
                port = ["-p", str(ssh_port)] if ssh_port else []
                cmd = ["ssh", "-o", "StrictHostKeyChecking=no", *port, host,
                       " ".join(shlex.quote(c) for c in boot)]
                benv = None
            # The secret rides stdin, never argv (/proc/*/cmdline) —
            # task_fn reads the first line before serving anything.
            p = subprocess.Popen(cmd, env=benv, stdin=subprocess.PIPE,
                                 start_new_session=True)
            p.stdin.write((secret_b64 + "\n").encode("ascii"))
            p.stdin.flush()
            bootstraps.append(p)

        driver.wait_for_initial_registration(start_timeout)
        clients = {
            index: TaskClient(driver.task_addresses_for(index), key)
            for index in range(len(host_list))
        }
        # The job's store (rank 0's TCPStore) binds on the first job host; let
        # that host's task service pick a port free in ITS port space. A
        # literal "localhost" first host must be rewritten to a reachable
        # address when other hosts are remote.
        coord_host = host_list[0][0]
        if _is_local(coord_host) and any(not _is_local(h)
                                         for h, _ in host_list):
            from .rpc import local_addresses
            coord_host = local_addresses()[0]
        coordinator = f"{coord_host}:{clients[0].free_port()}"

        # Forward the launcher's tuning env to every rank (reference
        # exports env through mpirun -x; run/run.py:469-481). Host-side
        # basics (PATH etc.) come from the task service's own environment.
        fwd_env = {k: v for k, v in base_env.items()
                   if k.startswith(("HOROVOD", "TORCH", "NCCL", "CUDA"))
                   and k not in ("HOROVOD_LAUNCH_RPC",
                                 "HOROVOD_SECRET_KEY")}
        placements = _placements(host_list, np_)
        ranks = list(range(len(placements)))
        for rank, (host, local_rank, local_size, cross_rank) in \
                enumerate(placements):
            renv = _rank_env(fwd_env, coordinator, np_, rank, local_rank,
                             local_size, cross_rank, len(host_list))
            clients[cross_rank].run_command(rank, command, renv)

        # mpirun teardown semantics: first failure kills the job. A dead
        # bootstrap (ssh dropped / host rebooted) also ends the job — its
        # ranks would otherwise never report an exit code.
        host_lost = False
        while True:
            codes = driver.exit_codes()
            if any(c != 0 for c in codes.values()):
                break
            if len(codes) == len(ranks):
                break
            if any(p.poll() is not None for p in bootstraps):
                host_lost = True
                print("horovodrun: lost contact with a host (its task "
                      "service exited); tearing the job down.",
                      file=sys.stderr)
                break
            time.sleep(0.1)
        codes = driver.exit_codes()
        _print_job_summary(codes)
        if host_lost and not any(c != 0 for c in codes.values()):
            return 1
        return _job_code(codes.values())
    finally:
        # Terminate every task service (kills any still-running rank
        # processes and releases the task_fn idle loop on each host).
        for client in (clients or {}).values():
            try:
                client.terminate()
            except Exception:
                pass
        _terminate_all(bootstraps)
        driver.shutdown()


def launch_elastic(np_, command, min_workers=1, max_workers=None,
                   worker_restarts=3, restart_delay=1.0, start_timeout=30,
                   verbose=False, env=None, autoscale=False, policy=None,
                   policy_interval=5.0, summary_path=None):
    """Elastic supervision: per-worker restart instead of whole-job
    teardown (local slots; remote hosts use gang restart).

    Each worker is supervised individually. A transient failure
    (signal-killed — preemption/OOM — or a conventional temp-fail exit
    code) is restarted in place with exponential backoff, up to
    ``worker_restarts`` times per slot; a permanent failure (a Python
    error exit) retires the slot. The job keeps running while completed +
    live workers stay at or above ``min_workers`` — surviving ranks
    recover in-job via horovod_tpu_torch.elastic — and succeeds when every
    remaining worker exits 0.

    With ``autoscale=True`` a traffic-driven policy loop
    (:class:`horovod_tpu_torch.elastic.AutoscalePolicy`, or a caller-supplied
    ``policy`` with the same ``observe``/``record_resize`` surface) reads
    the workers' telemetry drops every ``policy_interval`` seconds and
    resizes the world between ``min_workers`` and ``max_workers``:

    - **scale-down** drains one victim (never rank 0 — it hosts the
      coordination service) with SIGTERM; under the preemption-grace
      contract (HOROVOD_ELASTIC_GRACE_SECONDS > 0) the victim commits,
      announces a *planned* departure, and exits ``EX_PREEMPTED`` while
      the survivors re-shard in-job at the next step boundary;
    - **scale-up** does not add a process to a live session (its process
      group is fixed at its creation), so the whole gang is
      drained the same graceful way and relaunched at the new size — the
      fresh workers resume from the grace snapshots.

    Workers that exit ``EX_PREEMPTED`` outside any supervisor decision
    (cluster preemption) retire their slot as a planned departure, not a
    failure, and the supervisor records a replacement-capacity request.
    The launcher's own SIGTERM is forwarded to the worker process groups
    as a graceful drain. A JSON run summary lands at ``summary_path``
    (or $HOROVOD_ELASTIC_SUMMARY) for harnesses and CI.
    """
    import json
    import tempfile

    from ..elastic.supervisor import (EX_PREEMPTED, RestartPolicy,
                                      classify_exit, describe_exit)
    from .. import metrics as hvd_metrics

    base_env = dict(env if env is not None else os.environ)
    max_workers = max_workers or np_
    min_workers = max(1, min_workers)
    np_run = min(np_, max_workers)
    in_job_recovery = base_env.get("HOROVOD_ELASTIC", "") not in (
        "", "0", "false", "False")
    try:
        grace = float(
            base_env.get("HOROVOD_ELASTIC_GRACE_SECONDS", "") or 0.0)
    except ValueError:
        grace = 0.0
    drain_window = _drain_window(base_env)

    policy_dir = None
    if autoscale:
        from ..elastic.policy import (AutoscalePolicy, compact_signals,
                                      read_signals)
        if policy is None:
            policy = AutoscalePolicy(min_workers=min_workers,
                                     max_workers=max_workers)
        # Workers drop telemetry signal files here (callbacks.py
        # TelemetryCallback); the env export below is what turns the
        # drops on in the workers.
        policy_dir = base_env.get("HOROVOD_ELASTIC_POLICY_DIR")
        if not policy_dir:
            policy_dir = tempfile.mkdtemp(prefix="hvd-elastic-policy-")
        os.makedirs(policy_dir, exist_ok=True)
        base_env["HOROVOD_ELASTIC_POLICY_DIR"] = policy_dir
    if grace > 0:
        # Grace snapshots need a shared directory that survives the
        # departing process so a resized gang can restore from them.
        grace_dir = base_env.get("HOROVOD_ELASTIC_GRACE_DIR")
        if not grace_dir:
            grace_dir = tempfile.mkdtemp(prefix="hvd-elastic-grace-")
        os.makedirs(grace_dir, exist_ok=True)
        base_env["HOROVOD_ELASTIC_GRACE_DIR"] = grace_dir

    summary_path = summary_path or base_env.get("HOROVOD_ELASTIC_SUMMARY")
    summary = {"generations": 0, "resizes": [], "preemptions": 0,
               "replacement_requests": 0, "initial_world": np_run,
               "final_world": np_run, "exit_code": None}

    def write_summary(code):
        summary["final_world"] = np_run
        summary["exit_code"] = code
        if not summary_path:
            return
        tmp = summary_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(summary, f, indent=2, sort_keys=True)
            os.replace(tmp, summary_path)
        except OSError as e:
            print(f"horovodrun: could not write job summary "
                  f"{summary_path}: {e}", file=sys.stderr)

    sigterm, restore_sigterm = _forward_sigterm()
    no_grace_warned = [False]

    def _run_gang(np_gang, resized):
        """Run one gang generation to completion.

        Returns ``("done", exit_code)`` when the job finished (or died),
        or ``("resize", target)`` when the gang was drained for a world
        resize and should be relaunched at ``target`` workers.
        """
        coordinator = f"localhost:{_free_port()}"
        placements = _placements([("localhost", np_gang)], np_gang)
        procs = {}       # rank -> live Popen
        spawned_at = {}  # rank -> walltime of the last spawn
        scheduled = {}   # rank -> restart-at walltime
        done = {}        # rank -> 0
        failed = {}      # rank -> last exit code (slot retired, failure)
        departed = {}    # rank -> EX_PREEMPTED (planned departure)
        draining = {}    # rank -> SIGKILL deadline of an in-flight drain
        policies = {rank: RestartPolicy(max_restarts=worker_restarts,
                                        base_delay=restart_delay)
                    for rank in range(np_gang)}
        budget_exhausted = [0]  # slots retired on a drained budget
                                # since the last policy tick
        next_tick = time.time() + policy_interval

        def spawn(rank):
            host, local_rank, local_size, cross_rank = placements[rank]
            renv = _rank_env(base_env, coordinator, np_gang, rank,
                             local_rank, local_size, cross_rank, 1)
            # Restart count rides the env so the WORKER's metrics
            # registry (the one hvd.metrics_snapshot()/bench.py read)
            # records it — the launcher's own registry is never
            # exported. The resize stamp works the same way: the
            # relaunched gang's runtime counts the resize exactly once
            # per process.
            renv["HOROVOD_TPU_ELASTIC_RESTARTS"] = str(
                policies[rank].attempts)
            if resized:
                renv["HOROVOD_TPU_ELASTIC_RESIZED"] = resized
            p = subprocess.Popen(command, env=renv,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT,
                                 start_new_session=True)
            procs[rank] = p
            spawned_at[rank] = time.time()
            threading.Thread(target=_stream, args=(p, rank, verbose),
                             daemon=True).start()

        def live_count():
            return len(procs) + len(scheduled)

        def collect_drained():
            """Account every exited proc after a whole-gang drain."""
            for rank, p in list(procs.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del procs[rank]
                if rc == EX_PREEMPTED:
                    summary["preemptions"] += 1
                    departed[rank] = rc
                elif rc == 0:
                    done[rank] = 0
                else:
                    failed[rank] = rc
            scheduled.clear()

        def gang_resize(target, reason):
            # A grown world can only arrive by gang restart (a fresh
            # process does not join a live session's group), so
            # EVERY worker drains gracefully — grace-commits and exits
            # EX_PREEMPTED — and the next generation relaunches at the
            # new size from the grace snapshots.
            print(f"horovodrun: resizing the gang {np_gang} -> {target} "
                  f"({reason}); draining all workers", file=sys.stderr)
            _terminate_all(procs, signal.SIGTERM,
                           escalate_after=drain_window)
            collect_drained()
            return ("resize", target)

        def drain_victim(rank, reason):
            p = procs.get(rank)
            if p is None or p.poll() is not None:
                return False
            try:
                os.killpg(p.pid, signal.SIGTERM)
            except ProcessLookupError:
                return False
            draining[rank] = time.time() + drain_window
            print(f"horovodrun: draining rank {rank} ({reason}); "
                  f"survivors re-shard in-job", file=sys.stderr)
            return True

        deadline = time.time() + start_timeout
        for rank in range(np_gang):
            if time.time() > deadline:
                # Same spawn-deadline contract as the non-elastic path.
                _terminate_all(procs)
                raise _start_timeout_error(start_timeout)
            spawn(rank)
        try:
            while procs or scheduled:
                now = time.time()
                if sigterm["tripped"]:
                    # Forward the launcher's own SIGTERM as a graceful
                    # drain: every worker gets its grace window before
                    # the kill escalates.
                    print("horovodrun: SIGTERM received; draining worker "
                          "process groups", file=sys.stderr)
                    _terminate_all(procs, signal.SIGTERM,
                                   escalate_after=drain_window)
                    collect_drained()
                    return ("done", 128 + signal.SIGTERM)
                for rank, at in list(scheduled.items()):
                    if now >= at:
                        del scheduled[rank]
                        hvd_metrics.ELASTIC_RESTARTS.inc()
                        spawn(rank)
                for rank, p in list(procs.items()):
                    rc = p.poll()
                    if rc is None:
                        if rank in draining and now > draining[rank]:
                            # The drain overstayed grace + drain margin:
                            # escalate. Survivors take the (slower)
                            # lost-worker path instead of the planned
                            # departure.
                            del draining[rank]
                            try:
                                os.killpg(p.pid, signal.SIGKILL)
                            except ProcessLookupError:
                                pass
                        continue
                    del procs[rank]
                    draining.pop(rank, None)
                    if rc == 0:
                        done[rank] = 0
                        continue
                    kind = classify_exit(rc)
                    print(f"horovodrun: rank {rank} {describe_exit(rc)} "
                          f"[{kind}]", file=sys.stderr)
                    if kind == "preempted":
                        # Planned departure: the worker grace-committed
                        # and announced goodbye — not a failure, and the
                        # slot is NOT restarted. The supervisor records
                        # a replacement-capacity request; the autoscale
                        # loop's next scale-up decision is what fills
                        # it (a replacement process cannot join the
                        # live session).
                        summary["preemptions"] += 1
                        summary["replacement_requests"] += 1
                        departed[rank] = rc
                        live = live_count()
                        if rank == 0 and live > 0 and not done:
                            # Rank 0 hosts the coordination service; the
                            # survivors cannot outlive it. Re-form the
                            # gang at the survivor count — everyone
                            # restores from grace snapshots.
                            print("horovodrun: rank 0 departed; "
                                  "re-forming the gang at the survivor "
                                  "count", file=sys.stderr)
                            return gang_resize(
                                live, "rank 0 preempted")
                        if (0 < live and live + len(done) < min_workers
                                and not done):
                            # Preemption pushed the world below the
                            # floor: replace capacity by re-forming the
                            # gang at min_workers.
                            print(f"horovodrun: below --min-workers="
                                  f"{min_workers} after a planned "
                                  f"departure; re-forming the gang",
                                  file=sys.stderr)
                            return gang_resize(
                                min_workers, "replacement capacity")
                        continue
                    if rank == 0:
                        # Rank 0 hosts the job's store (the TCPStore
                        # every session and the elastic decision log
                        # ride): its death ends the job, and a restarted
                        # rank 0 cannot resurrect the survivors'
                        # sessions — same contract as the reference's
                        # driver.
                        print("horovodrun: rank 0 (the coordinator "
                              "process, host of the job's store) died; "
                              "the job cannot continue "
                              "— tearing it down. Recover with a gang "
                              "restart (--max-restarts without "
                              "--elastic).", file=sys.stderr)
                        failed[rank] = rc
                        _terminate_all(procs)
                        _print_job_summary(failed)
                        return ("done", _job_code(failed.values()))
                    rpolicy = policies[rank]
                    uptime = now - spawned_at.get(rank, now)
                    if (in_job_recovery and uptime > start_timeout
                            and kind == "transient"):
                        print(f"horovodrun: rank {rank} ran "
                              f"{uptime:.0f}s — past the startup window "
                              f"of a live session, "
                              f"which a respawn cannot rejoin; retiring "
                              f"the slot (survivors recover in-job)",
                              file=sys.stderr)
                        kind = "mid-job loss"
                    if kind == "transient" and rpolicy.should_retry():
                        delay = rpolicy.next_delay()
                        print(f"horovodrun: restarting rank {rank} in "
                              f"{delay:.1f}s (attempt {rpolicy.attempts}"
                              f"/{rpolicy.max_restarts})",
                              file=sys.stderr)
                        scheduled[rank] = now + delay
                    else:
                        if (kind == "transient"
                                and not rpolicy.should_retry()):
                            # Restart budget exhausted: surface it to
                            # the autoscale policy as a scale-down
                            # signal instead of a silent stall.
                            budget_exhausted[0] += 1
                        failed[rank] = rc
                        remaining = (len(procs) + len(scheduled)
                                     + len(done) + len(departed))
                        if remaining < min_workers:
                            print(f"horovodrun: {remaining} worker(s) "
                                  f"left, below --min-workers="
                                  f"{min_workers}; tearing the job "
                                  f"down", file=sys.stderr)
                            _terminate_all(procs)
                            _print_job_summary(failed)
                            return ("done", _job_code(failed.values()))
                if (autoscale and now >= next_tick and not done
                        and (procs or scheduled)):
                    next_tick = now + policy_interval
                    # Fan-in before the poll: fold fresh per-worker files
                    # into one bundle (and let read_signals prune dead
                    # reporters' tombstones), so a long-lived autoscaling
                    # world costs O(1) file reads per tick, not O(world)
                    # (the control plane's fan-in, on files).
                    compact_signals(
                        policy_dir,
                        max_age=max(10.0, 3 * policy_interval))
                    signals = read_signals(
                        policy_dir, max_age=max(10.0, 3 * policy_interval))
                    # The policy judges the world as it stood BEFORE any
                    # budget-exhausted slot retired: its scale-down
                    # decision formalizes that shrink (the slot is
                    # already gone; only the accounting is pending).
                    world = live_count() + budget_exhausted[0]
                    decision = policy.observe(
                        signals, world,
                        budget_exhausted=budget_exhausted[0] > 0)
                    if budget_exhausted[0]:
                        if decision.direction == "down":
                            # The capacity already left with the retired
                            # slot; the decision records the shrink so
                            # the operator sees WHY the world is smaller.
                            print(f"horovodrun: scale-down "
                                  f"({decision.reason})", file=sys.stderr)
                            summary["resizes"].append(
                                {"direction": "down", "from": world,
                                 "to": decision.target,
                                 "reason": decision.reason})
                            policy.record_resize()
                        budget_exhausted[0] = 0
                    elif decision.direction == "down":
                        if grace <= 0:
                            if not no_grace_warned[0]:
                                no_grace_warned[0] = True
                                print("horovodrun: autoscale wants to "
                                      "scale down but "
                                      "HOROVOD_ELASTIC_GRACE_SECONDS is "
                                      "0 — graceful drains disabled, "
                                      "holding the world size",
                                      file=sys.stderr)
                        else:
                            victim = decision.victim_rank
                            if victim not in procs or victim == 0:
                                victim = max(
                                    (r for r in procs if r != 0),
                                    default=None)
                            if victim is not None and drain_victim(
                                    victim, decision.reason):
                                summary["resizes"].append(
                                    {"direction": "down", "from": world,
                                     "to": decision.target,
                                     "victim": victim,
                                     "reason": decision.reason})
                                policy.record_resize()
                    elif decision.direction == "up":
                        target = min(decision.target, max_workers)
                        if target > world:
                            summary["resizes"].append(
                                {"direction": "up", "from": world,
                                 "to": target,
                                 "reason": decision.reason})
                            policy.record_resize()
                            return gang_resize(target, decision.reason)
                time.sleep(0.05)
            if failed:
                _print_job_summary(failed)
            if (done and all(c == 0 for c in done.values())
                    and len(done) + len(departed) >= min_workers):
                # Retired and departed slots were absorbed: the
                # surviving gang completed (failure exit codes of
                # absorbed slots do not taint the job — same contract
                # as before autoscaling).
                return ("done", 0)
            if departed and not done and not failed:
                # The whole gang was preempted before finishing: the
                # job is resumable (grace snapshots landed), signal
                # preemption upward rather than claiming success.
                return ("done", EX_PREEMPTED)
            return ("done", _job_code(list(done.values())
                                      + list(failed.values())))
        finally:
            _terminate_all(procs, signal.SIGKILL)

    resized = None
    code = 1
    try:
        while True:
            if sigterm["tripped"]:
                code = 128 + signal.SIGTERM
                break
            summary["generations"] += 1
            outcome, payload = _run_gang(np_run, resized)
            if outcome == "resize":
                target = max(min(int(payload), max_workers), min_workers)
                resized = "up" if target > np_run else "down"
                np_run = target
                continue
            code = payload
            break
        return code
    finally:
        write_summary(code)
        restore_sigterm()


def launch(np_, command, hosts=None, ssh_port=None, start_timeout=None,
           verbose=False, env=None, via_services=None, disable_cache=False,
           elastic=False, min_workers=1, max_workers=None,
           worker_restarts=3, restart_delay=1.0, autoscale=False,
           policy=None, policy_interval=5.0, summary_path=None):
    """Spawn np_ ranks of ``command``; returns the max exit code.

    Teardown parity with mpirun: first failure kills the whole job
    (reference relies on mpirun for this; safe_shell_exec.py kills process
    groups the same way). ``via_services`` selects the RPC driver/task
    launch path (default: automatically when any host is remote, or when
    HOROVOD_LAUNCH_RPC=1). ``elastic=True`` switches to per-worker
    supervision (launch_elastic) instead — local slots only.
    """
    if not start_timeout:
        from ..config import Config
        start_timeout = Config.from_env().start_timeout
    host_list = _parse_hosts(hosts, np_)
    if elastic:
        if any(not _is_local(h) for h, _ in host_list):
            raise ValueError(
                "--elastic supervises local slots; for multi-host jobs "
                "use gang restart (--max-restarts) — a restarted remote "
                "worker cannot rejoin a live session.")
        return launch_elastic(np_, command, min_workers=min_workers,
                              max_workers=max_workers,
                              worker_restarts=worker_restarts,
                              restart_delay=restart_delay,
                              start_timeout=start_timeout,
                              verbose=verbose, env=env,
                              autoscale=autoscale, policy=policy,
                              policy_interval=policy_interval,
                              summary_path=summary_path)
    if any(not _is_local(h) for h, _ in host_list):
        # Fail fast on unreachable hosts; results are cached between
        # launches unless --disable-cache (reference: run/run.py:394-407).
        fn_cache = None
        if not disable_cache:
            from .cache import Cache, parameters_hash
            fn_cache = Cache(params_hash=parameters_hash(hosts, ssh_port))
        check_all_hosts_ssh_successful([h for h, _ in host_list],
                                       ssh_port, fn_cache=fn_cache)
    if via_services is None:
        from ..config import Config
        via_services = (any(not _is_local(h) for h, _ in host_list)
                        or Config.from_env().launch_rpc)
    if via_services:
        return launch_via_services(np_, command, host_list,
                                   ssh_port=ssh_port,
                                   start_timeout=start_timeout,
                                   verbose=verbose, env=env)
    base_env = dict(env if env is not None else os.environ)
    coordinator = f"{host_list[0][0]}:{_free_port()}"
    placements = _placements(host_list, np_)

    procs = []
    threads = []
    deadline = time.time() + start_timeout
    sigterm, restore_sigterm = _forward_sigterm()
    try:
        for rank, (host, local_rank, local_size, cross_rank) in \
                enumerate(placements):
            renv = _rank_env(base_env, coordinator, np_, rank, local_rank,
                             local_size, cross_rank, len(host_list))
            if _is_local(host):
                cmd = command
                popen_env = renv
            else:
                # Remote: carry env explicitly through ssh (the reference
                # exports env via mpirun -x; run/run.py:469-481).
                port = ["-p", str(ssh_port)] if ssh_port else []
                exports = " ".join(
                    f"{k}={shlex.quote(v)}" for k, v in renv.items()
                    if k.startswith(("HOROVOD", "TORCH", "NCCL", "CUDA",
                                     "PATH", "PYTHON")))
                cmd = (["ssh", "-o", "StrictHostKeyChecking=no", *port, host,
                        f"env {exports} "
                        + " ".join(shlex.quote(c) for c in command)])
                popen_env = base_env
            if time.time() > deadline:
                raise _start_timeout_error(start_timeout)
            p = subprocess.Popen(cmd, env=popen_env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT,
                                 start_new_session=True)
            procs.append(p)
            t = threading.Thread(target=_stream, args=(p, rank, verbose),
                                 daemon=True)
            t.start()
            threads.append(t)

        exit_codes = [None] * len(procs)
        while any(c is None for c in exit_codes):
            if sigterm["tripped"]:
                # Forward the launcher's SIGTERM as a graceful drain:
                # workers get the preemption-grace window (when enabled)
                # before the SIGKILL escalation.
                print("horovodrun: SIGTERM received; draining worker "
                      "process groups", file=sys.stderr)
                _terminate_all(procs, signal.SIGTERM,
                               escalate_after=_drain_window(base_env))
                for i, p in enumerate(procs):
                    if exit_codes[i] is None:
                        exit_codes[i] = p.poll()
                _print_job_summary([c for c in exit_codes
                                    if c is not None])
                return 128 + signal.SIGTERM
            for i, p in enumerate(procs):
                if exit_codes[i] is None:
                    rc = p.poll()
                    if rc is not None:
                        exit_codes[i] = rc
                        if rc != 0:
                            # mpirun semantics: tear the job down
                            _terminate_all(procs)
            time.sleep(0.1)
        for t in threads:
            t.join(timeout=5)
        _print_job_summary(exit_codes)
        return _job_code(exit_codes)
    finally:
        restore_sigterm()
        _terminate_all(procs, signal.SIGKILL)


def main(argv=None):
    args = parse_args(argv)
    if args.version:
        print(__version__)
        return 0
    if not args.command:
        print("horovodrun: no command given", file=sys.stderr)
        return 1
    max_restarts = args.max_restarts
    if max_restarts is None:
        raw = os.environ.get("HOROVOD_MAX_RESTARTS",  # hvdlint: disable=HVD003 -- CLI-layer default depends on --elastic and warns on malformed values; a static Config default can't
                             "3" if args.elastic else "0")
        try:
            max_restarts = int(raw)
        except ValueError:
            print(f"horovodrun: ignoring malformed HOROVOD_MAX_RESTARTS="
                  f"{raw!r} (want an integer)", file=sys.stderr)
            max_restarts = 0
    if args.elastic:
        # Per-worker supervision replaces the gang-restart loop: the
        # supervisor restarts individual workers (bounded by
        # max_restarts each) and the job survives while >= --min-workers
        # remain.
        try:
            return launch(args.np, args.command, hosts=args.host,
                          ssh_port=args.ssh_port,
                          start_timeout=args.start_timeout,
                          verbose=args.verbose,
                          disable_cache=args.disable_cache,
                          elastic=True, min_workers=args.min_workers,
                          max_workers=args.max_workers,
                          worker_restarts=max(0, max_restarts),
                          autoscale=args.autoscale,
                          policy_interval=args.policy_interval)
        except (ValueError, RuntimeError, TimeoutError) as e:
            print(f"horovodrun: {e}", file=sys.stderr)
            return 1
    attempts = max(0, max_restarts) + 1
    for attempt in range(attempts):
        try:
            code = launch(args.np, args.command, hosts=args.host,
                          ssh_port=args.ssh_port,
                          start_timeout=args.start_timeout,
                          verbose=args.verbose,
                          disable_cache=args.disable_cache)
        except ValueError as e:
            # static configuration error (host slots < np, bad -H syntax):
            # no restart can fix it — fail fast outside the retry loop
            print(f"horovodrun: {e}", file=sys.stderr)
            return 1
        except (RuntimeError, TimeoutError) as e:
            # clean CLI exit — the actionable per-host output already
            # printed; infrastructure failures participate in restarts
            print(f"horovodrun: {e}", file=sys.stderr)
            code = 1
        if code == 0:
            return 0
        if attempt + 1 < attempts:
            # Gang restart: the job tore down whole (first-failure
            # semantics), so a fresh launch re-forms the full gang and
            # every rank resumes from its checkpoint. No partial worlds.
            print(f"horovodrun: job failed (exit {code}); restarting "
                  f"(attempt {attempt + 2}/{attempts})", file=sys.stderr)
            time.sleep(1.0)
    return code


if __name__ == "__main__":
    sys.exit(main())
