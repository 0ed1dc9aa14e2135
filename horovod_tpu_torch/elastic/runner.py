"""The elastic recovery loop: catch membership aborts, re-rendezvous,
rebuild the job over the survivors, roll back, resume.

Counterpart of horovod_tpu/elastic/runner.py (upstream analog:
``hvd.elastic.run``, v0.20 Elastic Horovod). A lost peer surfaces as
:class:`~horovod_tpu_torch.exceptions.WorkerLostError` (a collective
with it failed, or the coordinator's lost-worker scan aborted the
engine's handles), a planned departure or a hosts-updated interrupt as
:class:`~horovod_tpu_torch.exceptions.HostsUpdatedError`; :func:`run`
then shuts the failed session down, agrees on the membership over the
job's store (rendezvous.py), re-inits over the survivors
(``init(comm=<their world ranks>)``: a new default group under the new
session's store prefix, with world size the survivors), restores the
last commit in place and broadcasts it, and calls the training function
again.

Scope: in-job recovery shrinks the job; growing it is the launcher's
(run/run.py: a gang restart through the grace drain). Process 0 hosts
the store; its loss ends the job, as the reference's driver does.
"""

import atexit
import functools
import itertools
import os
import signal as _signal
import sys
import threading
import time

import torch

from ..exceptions import HostsUpdatedError, WorkerLostError
from ..utils.logging import get_logger
from .supervisor import EX_PREEMPTED

_logger = get_logger()


class PreemptedExit(BaseException):
    """Internal control-flow: the preemption-grace post-commit hook
    raises this to unwind the training loop once the departure snapshot
    is safe; :func:`run` catches it and performs the process exit.
    BaseException-derived so a training loop's ``except Exception``
    cannot swallow the departure."""


# Preemption-grace state (install_preemption_grace). One per process —
# POSIX delivers SIGTERM to the process, not to a training function.
_preempt = {
    "installed": False,   # handler armed this process
    "flag": False,        # SIGTERM received, departure pending
    "t_signal": None,     # perf_counter at SIGTERM receipt
    "deadline": None,     # perf_counter we must be gone by
    "grace": 0.0,
    "state": None,        # the elastic.State to snapshot on departure
    "lock": threading.Lock(),
    "departing": False,   # a departure path claimed the exit
}

# Exit guard (armed after the first lost-worker recovery): interpreter
# teardown would run the destructors of what the failed session left
# (its process group's transport threads, a communicator whose peer is
# gone) with nothing left to answer them. The guard runs this library's
# own shutdown (profiler dump, metrics final export, timeline close),
# flushes stdio, and _exits past them. Known limitation: after such a
# recovery the process exit code is 0/1 by training outcome; an explicit
# nonzero sys.exit() code is not preserved.
_exit_guard = {"armed": False, "failed": False}


def _arm_exit_guard():
    if _exit_guard["armed"]:
        return
    _exit_guard["armed"] = True
    previous_hook = sys.excepthook

    def hook(tp, value, tb):
        _exit_guard["failed"] = True
        previous_hook(tp, value, tb)

    sys.excepthook = hook

    def guard():
        try:
            from .. import runtime
            runtime._shutdown_atexit()
        except Exception:  # noqa: BLE001 — exiting regardless
            pass
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:  # noqa: BLE001
            pass
        os._exit(1 if _exit_guard["failed"] else 0)

    atexit.register(guard)

def preemption_requested():
    """True once SIGTERM arrived and the grace departure is pending —
    training loops can poll this to skip optional work (eval, logging)
    and reach the next commit boundary sooner."""
    return _preempt["flag"]


def install_preemption_grace(state, grace_seconds, linger=0.3):
    """Arm the SIGTERM preemption-grace path for ``state``.

    On SIGTERM: a flag flips (``preemption_requested()``), and at the
    next ``state.commit()`` boundary — when the snapshot is already
    safe — the worker writes a grace file (HOROVOD_ELASTIC_GRACE_DIR),
    announces a *planned* departure through the coordinator (peers
    re-shard at their next step boundary instead of waiting out the
    lost-worker timeout), and exits with EX_PREEMPTED so the supervisor
    files the exit as preemption, not failure. A watchdog thread
    force-saves the LAST commit and exits at the grace deadline if the
    step boundary never arrives (a wedged or very long step).

    Called by :func:`run` when ``HOROVOD_ELASTIC_GRACE_SECONDS > 0``;
    idempotent, main-thread only (signal.signal constraint — a
    non-main-thread caller gets a no-op and a warning). Returns True
    when the handler was installed."""
    _preempt["state"] = state
    _preempt["grace"] = float(grace_seconds)
    if _preempt["installed"]:
        return True

    def handler(signum, frame):
        now = time.perf_counter()
        _preempt["flag"] = True
        _preempt["t_signal"] = now
        _preempt["deadline"] = now + _preempt["grace"]
        _logger.warning(
            "elastic: SIGTERM received — departing at the next commit "
            "boundary (grace window %.1fs)", _preempt["grace"])
        threading.Thread(target=_grace_watchdog, daemon=True,
                         name="hvd-tpu-grace").start()

    try:
        _signal.signal(_signal.SIGTERM, handler)
    except ValueError:
        _logger.warning(
            "elastic: preemption grace needs the main thread to install "
            "its SIGTERM handler; grace path disabled in this context")
        return False
    _preempt["installed"] = True
    state.register_post_commit_hook(lambda: _maybe_depart(linger))
    return True


def _maybe_depart(linger):
    """Post-commit hook: the planned exit ramp. Runs on the training
    thread right after a commit landed, so departing here loses zero
    committed work."""
    if not _preempt["flag"]:
        return
    with _preempt["lock"]:
        if _preempt["departing"]:
            return
        _preempt["departing"] = True
    _depart_and_exit(linger, forced=False)


def _grace_watchdog():
    """Deadline backstop: if the commit boundary never arrives inside
    the grace window (a wedged collective, an enormous step), save the
    last commit and exit anyway — a preempting scheduler's SIGKILL is
    coming regardless, and a stale-but-consistent snapshot beats none."""
    while True:
        remaining = _preempt["deadline"] - time.perf_counter()
        if remaining <= 0:
            break
        time.sleep(min(remaining, 0.05))
    with _preempt["lock"]:
        if _preempt["departing"]:
            return
        _preempt["departing"] = True
    _logger.warning(
        "elastic: grace window (%.1fs) expired before a commit boundary; "
        "force-saving the last commit and exiting", _preempt["grace"])
    _depart_and_exit(0.0, forced=True)


def _depart_and_exit(linger, forced):
    """Common departure tail: grace snapshot, goodbye, metrics, exit.
    ``forced`` (watchdog path) exits the process directly; the hook path
    raises PreemptedExit so the training stack unwinds first."""
    from .. import metrics

    state = _preempt["state"]
    try:
        path = state.save_grace() if state is not None else None
        if path:
            _logger.warning("elastic: grace snapshot written to %s", path)
    except Exception:  # noqa: BLE001 — still announce + exit on time
        _logger.exception("elastic: grace snapshot failed")
    _announce_departure()
    dt = time.perf_counter() - _preempt["t_signal"]
    metrics.ELASTIC_PREEMPTIONS.inc()
    metrics.ELASTIC_GRACE_COMMIT_SECONDS.observe(dt)
    _logger.warning(
        "elastic: planned departure committed %.2fs after SIGTERM "
        "(grace window %.1fs)", dt, _preempt["grace"])
    if forced:
        _exit_preempted(linger)
    raise PreemptedExit


def _announce_departure():
    """Best-effort goodbye through the coordinator's store: the signal
    that turns this exit into a planned departure for the peers.
    Single-process jobs (no coordinator) skip it; if the write fails,
    the liveness timeout remains the backstop."""
    try:
        from .. import runtime
        engine = runtime._state.engine
        coord = engine.coordinator if engine is not None else None
        if coord is not None:
            coord.announce_departure()
    except Exception:  # noqa: BLE001 — liveness timeout is the backstop
        pass


def _exit_preempted(linger):
    """Leave NOW, without the cooperative teardown: hvd.shutdown()
    would publish a shutdown announce (failing every peer's next
    collective with ShutDownError — the opposite of a quiet departure),
    and a normal interpreter exit would tear down a process group the
    continuing peers still hold (see _arm_exit_guard). A short linger
    lets peers drain wire collectives this process already
    participated in."""
    remaining = 0.0
    if _preempt["deadline"] is not None:
        remaining = _preempt["deadline"] - time.perf_counter()
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:  # noqa: BLE001
        pass
    time.sleep(max(0.0, min(linger, remaining)))
    os._exit(EX_PREEMPTED)


# Recovery generation: advances once per recovery on every survivor (each
# global abort decision reaches each survivor exactly once), so the
# counter agrees across processes without communication and namespaces
# each rendezvous round uniquely — a stale join key from generation N can
# never leak into generation N+1.
_generation = itertools.count(1)


def run(fn):
    """Decorate a training function ``fn(state, *args, **kwargs)`` for
    elastic execution: on a membership abort, recover and re-invoke it.

    ``state`` must be an :class:`~horovod_tpu_torch.elastic.State`;
    ``fn`` should ``state.commit()`` at step boundaries it is willing to
    roll back to, and derive ALL progress (step counters included) from
    the state so a re-invocation continues instead of restarting. A
    backend error of a collective that escaped translation (a direct
    ``torch.distributed`` call) is translated here the same way
    (ops/collectives.py ``peer_error``).
    """
    from ..ops.collectives import peer_error

    @functools.wraps(fn)
    def wrapper(state, *args, **kwargs):
        _maybe_install_grace(state)
        while True:
            try:
                return fn(state, *args, **kwargs)
            except (WorkerLostError, HostsUpdatedError) as exc:
                _depart_if_preempted()
                _recover(state, exc)
            except PreemptedExit:
                _exit_preempted(0.3)
            except RuntimeError as err:
                exc = peer_error(err)
                if not isinstance(exc, (WorkerLostError, HostsUpdatedError)):
                    raise
                _depart_if_preempted()
                _recover(state, exc)
    return wrapper


def _depart_if_preempted():
    """A worker already told to leave (SIGTERM under the grace) whose
    collective failed before its next commit leaves now, from its last
    commit, instead of recovering: under a gang drain every worker is
    signalled at once, and the first to depart (rank 0 among them, whose
    store the recovery would need) fails its peers' exchange."""
    if not _preempt["flag"]:
        return
    with _preempt["lock"]:
        if _preempt["departing"]:
            return
        _preempt["departing"] = True
    _logger.warning("elastic: a collective failed after SIGTERM; departing "
                    "from the last commit instead of recovering")
    _depart_and_exit(0.0, forced=True)


def _maybe_install_grace(state):
    """Arm the SIGTERM grace path when configured (strictly opt-in:
    HOROVOD_ELASTIC_GRACE_SECONDS=0, the default, changes nothing)."""
    from .. import runtime
    if runtime.is_initialized():
        cfg = runtime.live_state().config
    else:
        from ..config import Config
        cfg = Config.from_env()
    if cfg is not None and cfg.elastic_grace_seconds > 0:
        install_preemption_grace(state, cfg.elastic_grace_seconds)


def _recover(state, exc):
    """One bounded-time recovery: shutdown -> rendezvous -> re-init over
    the survivors -> rollback -> sync. Raises (ending the job) only when
    the survivors cannot form a quorum or the store itself is gone."""
    from .. import metrics, runtime
    from .rendezvous import rendezvous

    t0 = time.perf_counter()
    generation = next(_generation)
    st = runtime.live_state()
    cfg, device = st.config, st.device
    members = list(st.members)
    me = st.world_rank
    # the abort names session ranks; the rendezvous and comm= world ranks
    lost = {members[r] for r in getattr(exc, "lost_pids", ())
            if 0 <= r < len(members)}
    expected = sorted(set(members) - lost)
    cause = exc.__cause__
    _logger.warning(
        "elastic: recovery generation %d after %s — expected survivors "
        "%s", generation, type(exc).__name__, expected, exc_info=exc)
    # Tear the failed session down first: its group (whose dead member
    # never answers), its engine and every program captured over it. A
    # group the caller made and init() adopted is left by shutdown() to
    # its owner; it has a dead member all the same, and the survivors'
    # group takes its place, with its backend.
    backend = st.backend
    runtime.shutdown()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    survivors = rendezvous(generation, expected, me, min_workers=1,
                           settle=cfg.elastic_settle_seconds)
    if (set(survivors) == set(members) and cause is not None
            and isinstance(exc, WorkerLostError) and not exc.lost_pids):
        # every worker rejoined: the collective's failure lost no peer,
        # and another round would fail the same way
        _logger.error("elastic: all %d workers rejoined after a failed "
                      "collective; raising its error", len(members))
        raise cause
    runtime._init(survivors, device, backend)
    state.restore()
    state.sync(root_rank=0)
    departed = sorted(set(members) - set(survivors))
    if departed:
        _arm_exit_guard()
        state.suspend_durable(
            f"worker(s) {departed} left; membership shrank")
    dt = time.perf_counter() - t0
    metrics.ELASTIC_RECOVERY_SECONDS.observe(dt)
    metrics.ELASTIC_WORLD_SIZE.set(len(survivors))
    if departed and isinstance(exc, HostsUpdatedError):
        metrics.ELASTIC_RESIZES.labels(direction="down").inc()
    elif departed and not getattr(exc, "lost_pids", ()):
        # found by a failed collective (the engine's abort counts its own)
        metrics.ELASTIC_WORKERS_LOST.inc(len(departed))
    _logger.warning(
        "elastic: recovered in %.2fs — continuing on %d worker(s) %s",
        dt, len(survivors), survivors)


def notify_hosts_updated():
    """Cooperatively interrupt the job for a membership change (process 0
    only): every process's next collective raises
    :class:`HostsUpdatedError`, and :func:`run` re-rendezvouses at the
    same decision index. Deployment tooling calls this ahead of a planned
    topology change (e.g. draining a host before maintenance)."""
    from .. import runtime
    coord = runtime.engine().coordinator
    if coord is None:
        raise ValueError(
            "notify_hosts_updated needs a multi-process job (single-host "
            "jobs have no membership to update)")
    coord.announce_hosts_updated()
