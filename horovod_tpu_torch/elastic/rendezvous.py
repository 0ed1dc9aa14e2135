"""Coordinator-driven re-rendezvous: epoch-numbered membership agreement
over the job's ``TCPStore`` (utils/store_kv.py), the store the
coordinator uses.

Counterpart of horovod_tpu/elastic/rendezvous.py, whose KV is
jax.distributed's: the same two phases, keys, settle window and quorum
timeout. The store is process 0's and outlives every session, so it is
there between the failed session's teardown and the recovered one's
init.

After an elastic abort every survivor must agree on the new membership
before rebuilding the mesh — unilaterally continuing with "whoever I
think survived" would diverge device sets and wedge the first collective.
The protocol is two KV phases under a generation-numbered namespace
(generations never reuse keys, so a stale join from a previous recovery
can never pollute a later one):

1. **join** — every survivor writes ``join/{pid}``;
2. **view** — the leader (lowest expected pid; process 0 in practice,
   since the job dies with it anyway — it hosts the coordination
   service) collects joins until either every expected survivor arrived
   or a settle window elapsed past quorum, then publishes the membership
   ``view`` everyone else blocks on.

The result is the same sorted pid list on every survivor. Workers that
were expected but never joined within the window are treated as lost —
a second failure during recovery shrinks the membership further instead
of deadlocking the rendezvous.
"""

import json
import time

from ..exceptions import CoordinatorError
from ..utils.logging import get_logger

_logger = get_logger()

_PREFIX = "hvd/elastic/rdzv"


def _default_client():
    from .. import runtime
    from ..utils.store_kv import StoreKV
    return StoreKV(runtime.job_store())


def rendezvous(generation, expected, pid, *, min_workers=1, timeout=60.0,
               settle=1.0, client=None):
    """Agree on the membership for recovery ``generation``.

    Args:
      generation: recovery counter, identical on every survivor (each
        global abort reaches each survivor exactly once, so a local
        counter agrees without communication); namespaces the KV keys.
      expected: sorted pids believed to have survived (current session
        participants minus the abort's lost set).
      pid: this process's id.
      min_workers: quorum — fewer joiners than this raises instead of
        continuing with a uselessly small job.
      timeout: hard bound on the whole round.
      settle: leader's grace window for stragglers once quorum exists.
      client: KV client override (tests); defaults to the job's store.

    Returns the agreed sorted member pid list.
    """
    if client is None:
        client = _default_client()
    if pid not in expected:
        raise CoordinatorError(
            f"process {pid} is not in the expected survivor set "
            f"{list(expected)} — it cannot join this rendezvous")
    ns = f"{_PREFIX}/{int(generation)}"
    leader = min(expected)
    client.key_value_set_bytes(f"{ns}/join/{pid}", b"1",
                               allow_overwrite=True)
    deadline = time.perf_counter() + timeout
    if pid == leader:
        settle_deadline = None
        while True:
            joined = []
            for p in expected:
                try:
                    blob = client.key_value_try_get_bytes(f"{ns}/join/{p}")
                except Exception:  # noqa: BLE001 — a miss retries below
                    blob = None
                if blob:
                    joined.append(p)
            now = time.perf_counter()
            if len(joined) == len(expected):
                break
            if len(joined) >= min_workers:
                if settle_deadline is None:
                    settle_deadline = now + settle
                elif now >= settle_deadline:
                    _logger.warning(
                        "elastic rendezvous %d: continuing with %s; "
                        "expected survivor(s) %s never joined",
                        generation, joined,
                        sorted(set(expected) - set(joined)))
                    break
            if now > deadline:
                raise CoordinatorError(
                    f"elastic rendezvous {generation} timed out: only "
                    f"{joined} of expected {list(expected)} joined within "
                    f"{timeout:.0f}s (quorum {min_workers})")
            time.sleep(0.05)
        members = sorted(joined)
        client.key_value_set_bytes(
            f"{ns}/view", json.dumps({"members": members}).encode(),
            allow_overwrite=True)
        # Key hygiene in the process-lifetime store (same discipline as
        # the coordinator's session-key cleanup): join keys are consumed
        # — only the leader reads them — so reclaim them now; the view
        # must outlive this round for the followers, so the PREVIOUS
        # generation's view (everyone consumed it long ago) is reclaimed
        # instead.
        for p in expected:
            try:
                client.key_value_delete(f"{ns}/join/{p}")
            except Exception:  # noqa: BLE001 — hygiene only
                pass
        if generation > 1:
            try:
                client.key_value_delete(
                    f"{_PREFIX}/{int(generation) - 1}/view")
            except Exception:  # noqa: BLE001 — hygiene only
                pass
    else:
        while True:
            try:
                blob = client.blocking_key_value_get_bytes(
                    f"{ns}/view", 1000)
            except Exception:  # noqa: BLE001 — timeout; retry to deadline
                blob = None
            if blob:
                members = json.loads(bytes(blob).decode())["members"]
                break
            if time.perf_counter() > deadline:
                raise CoordinatorError(
                    f"elastic rendezvous {generation}: no membership view "
                    f"from leader {leader} within {timeout:.0f}s — the "
                    f"leader likely died; the job cannot recover")
        if pid not in members:
            # The leader's settle window closed before our join landed:
            # continuing would rebuild a mesh that excludes this process
            # and hang its first collective. Fail loud instead — the
            # supervisor treats the exit like any other lost worker.
            raise CoordinatorError(
                f"elastic rendezvous {generation}: this process (pid "
                f"{pid}) was dropped from the membership view {members} "
                f"(joined after the leader's settle window); it cannot "
                f"rejoin the running job")
    from .. import metrics
    metrics.ELASTIC_RENDEZVOUS_ROUNDS.inc()
    _logger.info("elastic rendezvous %d: membership %s", generation,
                 members)
    return members
