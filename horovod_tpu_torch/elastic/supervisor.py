"""Worker supervision policy: exit-code classification and restart
backoff, for the launcher's ``--elastic`` mode.

Counterpart of horovod_tpu/elastic/supervisor.py, copied (plain
Python). The launcher that uses it is run/run.py (``launch_elastic``).

Upstream analog: Elastic Horovod's driver, which distinguishes hosts
that *failed* (blacklist + replace) from workers that merely died
transiently (restart in place), instead of mpirun's
first-failure-kills-the-job. The policy layer lives here so it is
importable and unit-testable without spawning processes; the launcher
owns the process lifecycle.
"""

import signal

# Conventional transient exit codes: EX_TEMPFAIL (sysexits.h) and the
# coreutils `timeout` code. Everything else positive is treated as a
# programming/config error a restart cannot fix.
TRANSIENT_EXIT_CODES = frozenset({75, 124})

# A worker that handled SIGTERM through the preemption-grace path
# (elastic/runner.py) exits with this code: the departure was PLANNED —
# committed state, goodbye announced — so the supervisor retires the
# slot cleanly instead of burning restart budget or calling it a
# failure. 79 is unassigned in sysexits.h's 64-78 block.
EX_PREEMPTED = 79


def classify_exit(code):
    """Classify a worker's exit code: ``"ok"`` | ``"preempted"`` |
    ``"transient"`` | ``"permanent"``.

    Signal-killed workers (negative ``Popen.returncode``) are transient:
    SIGKILL/SIGTERM is how preemption, the OOM killer, and node drains
    present, and a restart (or continuing with the survivors) is the
    right response. ``EX_PREEMPTED`` is the grace path's planned-exit
    code — neither failure nor restartable. A Python-error exit (code 1
    etc.) is permanent — the same code would crash the same way again.
    """
    if code == 0:
        return "ok"
    if code == EX_PREEMPTED:
        return "preempted"
    if code < 0 or code in TRANSIENT_EXIT_CODES:
        return "transient"
    return "permanent"


def describe_exit(code):
    """Human-readable exit description for the job summary: a
    signal-killed worker reads distinctly from a Python-error exit."""
    if code == 0:
        return "exited cleanly"
    if code == EX_PREEMPTED:
        return ("departed after preemption grace "
                f"(exit {EX_PREEMPTED}, planned)")
    if code < 0:
        try:
            name = signal.Signals(-code).name
        except ValueError:
            name = f"signal {-code}"
        return f"killed by {name} (signal {-code})"
    return f"exited with code {code}"


class RestartPolicy:
    """Exponential-backoff restart budget for one worker slot."""

    def __init__(self, max_restarts=3, base_delay=1.0, factor=2.0,
                 max_delay=30.0):
        self.max_restarts = max(int(max_restarts), 0)
        self.base_delay = float(base_delay)
        self.factor = float(factor)
        self.max_delay = float(max_delay)
        self.attempts = 0

    def should_retry(self):
        return self.attempts < self.max_restarts

    def next_delay(self):
        """Consume one attempt; returns the pre-restart delay in
        seconds (base * factor^attempt, capped)."""
        delay = min(self.base_delay * (self.factor ** self.attempts),
                    self.max_delay)
        self.attempts += 1
        return delay
