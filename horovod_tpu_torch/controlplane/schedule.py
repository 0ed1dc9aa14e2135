"""Static-schedule graduation: the coordinator-side bookkeeping.

The response-cache fast lane (coordinator.py) already lets a process
replay a learned decision locally — but it forces a coordinator round
every ``_FAST_LANE_REFRESH`` cycles, and the coordinator still reads
every request key every round. Graduation generalizes the lane into a
*fixed schedule*: once the coordinator has answered the same (pid,
fingerprint) pending set with the same decision epoch for
``graduate_after`` consecutive negotiated rounds, it attaches a
``{"grad": [{"pid", "fp"}]}`` hint to the decision. The owning process
then executes that set from its local decision registry with NO refresh
cap and NO publish — and once every participant is graduated the root
drops to a single wake-key probe per round (coordinator.coordinate).

Demotion is instant and layered (docs/controlplane.md):

- **coordinator side** (this class): any fresh submission from a
  graduated pid (shape churn, new tensors — it would not be publishing
  otherwise) demotes that pid; any shutdown or stall-warning decision
  demotes everyone, as does an epoch eviction for a graduated
  fingerprint.
- **process side** (coordinator.fetch_decisions / the lane lookup):
  the same decisions clear the local graduated map, and a graduated
  process re-checks the decision log at least every
  ``coord_graduate_refresh_seconds`` so a demotion decided while it was
  coordinator-free lands within one refresh window.

Decisions stay bit-identical with graduation on vs off in the sense
that matters: the tensor entries every process executes, per round, are
the same decision-epoch entries full negotiation would have replayed
(the grad/demote hints ride ALONGSIDE otherwise-unchanged decisions;
simrank's paired-world check compares the executed entries byte for
byte).
"""

from .. import metrics


class ScheduleManager:
    """Tracks per-(pid, fingerprint) decision streaks and the graduated
    set. Process 0 only; every method is called with the coordinator's
    state lock held (the manager keeps no lock of its own)."""

    def __init__(self, graduate_after):
        self.graduate_after = max(int(graduate_after), 1)
        # (pid, fp) -> [deid, consecutive-identical-round count]
        self._streak = {}
        self._graduated = {}  # pid -> fp

    def observe_answer(self, pid, fp, deid):
        """One negotiated round fully answered ``pid``'s set ``fp`` with
        decision epoch ``deid``. Returns True when this observation
        graduates the set (caller attaches the hint)."""
        if self._graduated.get(pid) == fp:
            return False
        rec = self._streak.get((pid, fp))
        if rec is None or rec[0] != deid:
            self._streak[(pid, fp)] = [deid, 1]
            return False
        rec[1] += 1
        if rec[1] < self.graduate_after:
            return False
        self._graduated[pid] = fp
        del self._streak[(pid, fp)]
        metrics.CTRL_SCHEDULE_TRANSITIONS.labels(kind="graduate").inc()
        metrics.CTRL_GRADUATED_SETS.set(len(self._graduated))
        return True

    def note_submission(self, pid, fp):
        """``pid`` published a pending set this round. A graduated pid
        publishing ANYTHING is off its schedule (its schedule-hit path
        never publishes), so demote it — including when it re-publishes
        its graduated fingerprint (it lost the local registry entry)."""
        if pid in self._graduated:
            self.demote(pid, "submission")
        # Not graduated: a changed set resets the streak through
        # observe_answer's deid/fp mismatch; nothing to track here.

    def demote(self, pid, reason):
        if self._graduated.pop(pid, None) is None:
            return
        self._streak = {k: v for k, v in self._streak.items()
                        if k[0] != pid}
        metrics.CTRL_SCHEDULE_TRANSITIONS.labels(kind="demote").inc()
        metrics.CTRL_GRADUATED_SETS.set(len(self._graduated))

    def demote_all(self, reason):
        """A shutdown or a stall warning: the steady state those
        schedules encoded no longer exists."""
        n = len(self._graduated)
        self._graduated.clear()
        self._streak.clear()
        if n:
            metrics.CTRL_SCHEDULE_TRANSITIONS.labels(kind="demote").inc(n)
            metrics.CTRL_GRADUATED_SETS.set(0)

    def demote_fp(self, pid, fp, reason):
        """Epoch eviction for a graduated fingerprint."""
        if self._graduated.get(pid) == fp:
            self.demote(pid, reason)

    def graduated(self, pid):
        return self._graduated.get(pid)

    def all_graduated(self, pids):
        """True when every participant runs on a fixed schedule — the
        gate for the root's static (wake-probe-only) rounds."""
        return bool(pids) and all(p in self._graduated for p in pids)
