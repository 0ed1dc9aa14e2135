"""Rank functions and launched scripts for the autotune, launcher and
autoscale tests (test_torch_autotune.py, test_torch_launcher.py,
test_torch_autoscale.py). No JAX here: every rank imports this module.

As a script, ``python tests/torch_launch_workers.py MODE ...`` is one
worker a test launches through ``python -m horovod_tpu_torch.run``:

- ``allreduce OUT``: ``hvd.init(device="cpu")``, one all-reduce of
  ``rank + 1``, the result written to ``OUT/rank<R>.json``;
- ``fail_once MARKER``: exit 1 when MARKER does not exist (creating it),
  else 0 — a job that fails its first generation;
- ``fail``: exit 3;
- ``grace READY``: a commit loop under ``hvd.elastic.run`` with the
  preemption grace armed (``HOROVOD_ELASTIC_GRACE_SECONDS`` in the
  environment); touches ``READY<rank>`` after its first commit, and
  answers SIGTERM at the next commit with the grace exit (79);
- ``grace_lost``: the grace armed, a commit, SIGTERM, then a lost peer
  before the next commit: the worker departs (79) from its commit;
- ``env OUT``: write the launcher's variables to ``OUT/rank<R>.json``.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _rank():
    return int(os.environ["HOROVOD_TPU_PROCESS_ID"])


def autotune_session(steps, n_tensors, elems):
    """Rank function: ``HOROVOD_AUTOTUNE=1`` (set by the caller's env),
    ``n_tensors`` all-reduces a step for ``steps`` steps. Returns the
    engine's applied autotune list, the indices (in this rank's fetched
    decision stream) at which autotune decisions arrived, every fusion
    plan the engine made with the threshold it was made under, the
    bucket count of every step, whether this rank holds a tuner, and a
    digest of the results.

    The threshold is read where the engine plans, never by the host
    between steps: a decision fetched after a step's last synchronize
    lands before the host's next read on one rank and after it on the
    other, while both plan every bucket under the same threshold."""
    import hashlib

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    hvd.init(device="cpu")
    state = hvd.runtime.live_state()
    engine = state.engine
    coord = engine.coordinator
    stream = []
    plans = []
    fetch = coord.fetch_decisions
    plan = engine._plan_fusion

    def logged_fetch(*a, **kw):
        out = fetch(*a, **kw)
        for d in out:
            stream.append(bool(d.get("autotune")))
        return out

    def logged_plan(allreduces):
        out = plan(allreduces)
        plans.append((int(engine.config.fusion_threshold),
                      [[e.name for e, _ in batch] for batch, _ in out]))
        return out

    coord.fetch_decisions = logged_fetch
    engine._plan_fusion = logged_plan
    r = hvd.rank()
    digest = hashlib.sha256()
    steps_log = []
    for s in range(steps):
        flushes = metrics.ENGINE_BUCKET_FLUSHES.value()
        hs = [hvd.allreduce_async(
            torch.full((elems,), float(r + 1 + i)), average=False,
            name=f"at.{s}.{i}") for i in range(n_tensors)]
        for h in hs:
            digest.update(hvd.synchronize(h).numpy().tobytes())
        steps_log.append(metrics.ENGINE_BUCKET_FLUSHES.value() - flushes)
    if state.autotuner is not None:
        state.autotuner.active = False
    # a collective after the tuner stopped: every decision process 0
    # published before it precedes it in the log, so each rank has
    # applied all of them once it completes
    hvd.allreduce(torch.zeros(1), name="at.barrier")
    out = {"applied": list(engine.applied_autotune),
           "indices": [i for i, a in enumerate(stream) if a],
           "plans": plans,
           "steps": steps_log,
           "tuner": state.autotuner is not None,
           "digest": digest.hexdigest()}
    hvd.shutdown()
    return out


def _script(argv):
    mode = argv[0]
    if mode == "allreduce":
        import torch

        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        out = hvd.allreduce(torch.full((4,), float(hvd.rank() + 1)),
                            average=False, name="launch.x")
        rec = {"rank": hvd.rank(), "size": hvd.size(),
               "sum": out.tolist()}
        hvd.shutdown()
        with open(os.path.join(argv[1], f"rank{rec['rank']}.json"),
                  "w") as f:
            json.dump(rec, f)
        return 0
    if mode == "fail_once":
        if os.path.exists(argv[1]):
            return 0
        with open(argv[1], "w") as f:
            f.write("failed once\n")
        return 1
    if mode == "fail":
        return 3
    if mode == "grace":
        import horovod_tpu_torch as hvd
        state = hvd.elastic.State(step=0)
        ready = f"{argv[1]}{_rank()}"

        @hvd.elastic.run
        def train(state):
            deadline = time.time() + 60
            while time.time() < deadline:
                state.step += 1
                state.commit()
                if state.step == 1:
                    with open(ready, "w") as f:
                        f.write(str(os.getpid()))
                time.sleep(0.05)
            return 1
        return train(state)
    if mode == "grace_lost":
        # SIGTERM lands after a commit, then the next exchange fails (a
        # peer of the same drain left first): the worker must depart
        # from its commit (exit 79, a grace file), not recover
        import signal

        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.exceptions import WorkerLostError
        state = hvd.elastic.State(step=0)

        @hvd.elastic.run
        def train(state):
            state.step = 1
            state.commit()
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.2)  # the handler runs at the next bytecode
            raise WorkerLostError(lost_pids=[0])
        train(state)
        return 1
    if mode == "env":
        keys = [k for k in os.environ if k.startswith(("HOROVOD_TPU_",
                                                       "HOROVOD_RANK",
                                                       "HOROVOD_SIZE",
                                                       "HOROVOD_LOCAL"))]
        with open(os.path.join(argv[1], f"rank{_rank()}.json"), "w") as f:
            json.dump({k: os.environ[k] for k in keys}, f)
        return 0
    raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    sys.exit(_script(sys.argv[1:]))
