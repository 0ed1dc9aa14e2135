"""The session's store outlives the session (ROADMAP.md Queue 3, fixed).

``shutdown()`` -> ``init()`` in one process used to build a new
``TCPStore`` at the coordinator's port, and under load a rank's client
could reach the old store as it closed (``ProcessGroupGloo`` failing
with ``Broken pipe``; ``bench.transformer``'s ``run_moe_benchmark``
re-inits so for its expert mesh). The runtime now keeps one store a
coordinator address for the process's life, as the JAX package keeps
one KV service for all sessions (horovod_tpu/utils/compat.py), and
each session's process group keys its rendezvous under
``hvd/<session>/pg/``. Two-rank jobs re-init repeatedly, several at
once, with the expert mesh on every third session, and every session's
engine and direct collectives complete.
"""

import threading

import numpy as np

from torch_engine_workers import store_reinit
from torch_ranks import spawn_ranks

SESSIONS, JOBS = 6, 3


def test_reinit_over_one_store_never_breaks_the_pipe():
    results, errors = [None] * JOBS, []

    def job(i):
        try:
            results[i] = spawn_ranks(2, store_reinit, SESSIONS, 3,
                                     timeout=180)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=job, args=(i,)) for i in range(JOBS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0][-3000:]
    assert not any("Broken pipe" in e for e in errors)
    for ranks in results:
        for rank in ranks:
            assert rank["stores"] == 1  # one TCPStore for every session
            for s, (a, b, ep) in enumerate(rank["sums"]):
                np.testing.assert_array_equal(a, np.full(3, 1.0 + 2 * s))
                np.testing.assert_array_equal(b, np.full(2, 1.0))
                assert ep == (2 if s % 3 == 2 else 1)
