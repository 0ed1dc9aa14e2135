"""Rank functions of the port's fault-tolerance tests (JAX-free: each
gloo rank imports this module; tests/torch_ranks.py spawns them).

Every wait is bounded: the process group's timeout is
``HOROVOD_ELASTIC_TIMEOUT_SECONDS`` (the tests set a few seconds), the
rendezvous has its own, and the launcher kills a rank that outlives its
timeout. A rank dies at a known step (``os.kill`` of itself), never
after a wall-clock delay.
"""

import json
import os
import signal
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd

# The dataset of the recovery runs: sample i's features are i itself, so
# a batch names the samples it holds.
NUM_SAMPLES = 48
BATCH = 2


def _dataset():
    idx = np.arange(NUM_SAMPLES, dtype=np.int64)
    x = np.stack([idx / NUM_SAMPLES, np.cos(idx)], axis=1).astype(np.float32)
    return hvd.data.DistributedDataset({"x": x, "i": idx}, batch_size=BATCH,
                                       seed=5, device="cpu")


def elastic_training(out_dir, victim, at_step, how="kill"):
    """World rank ``victim`` leaves at its step ``at_step`` (``how``:
    ``"kill"``, SIGKILL of itself before the step's exchange; ``"term"``,
    SIGTERM of itself, a planned departure through the preemption
    grace); the others recover through ``hvd.elastic.run``. Every
    committed batch's sample ids go to ``consumed-<world rank>.jsonl``
    after its commit. Returns this rank's record."""
    hvd.init(device="cpu")
    me = hvd.runtime.world_rank()
    torch.manual_seed(0)
    model = torch.nn.Linear(2, 1)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    ds = _dataset()
    state = hvd.elastic.State(model=model, optimizer=opt, step=0)
    hvd.data.attach_to_state(state, ds)
    state.commit()
    log = open(os.path.join(out_dir, f"consumed-{me}.jsonl"), "a")
    record = {"recoveries": 0, "sizes": []}
    t0 = [None]

    @hvd.elastic.run
    def train(state):
        if t0[0] is not None:
            record["recovery_s"] = time.perf_counter() - t0[0]
            record["recoveries"] += 1
        record["sizes"].append(hvd.size())
        for batch in ds:
            if me == victim and state.step == at_step:
                if how == "kill":
                    os.kill(os.getpid(), signal.SIGKILL)
                os.kill(os.getpid(), signal.SIGTERM)
            opt.zero_grad()
            loss = model(batch["x"]).pow(2).mean()
            loss.backward()
            t0[0] = time.perf_counter()
            opt.step()
            # the exchange went through on every rank: the batch is
            # consumed (the next commit takes it; a departing rank
            # leaves inside that commit)
            log.write(json.dumps({"rank": me, "step": state.step,
                                  "size": hvd.size(),
                                  "ids": batch["i"].tolist()}) + "\n")
            log.flush()
            state.step += 1
            state.commit()

    train(state)
    record["step"] = state.step
    record["params"] = [p.detach().clone() for p in model.parameters()]
    log.close()
    hvd.shutdown()
    return record


def lost_worker_handles(victim):
    """Rank ``victim`` exits at once after the first exchange; the
    others submit eager-engine allreduces that it will never join: every
    handle raises WorkerLostError (the coordinator's lost-worker scan, or
    the collective's failure), within the elastic timeout."""
    hvd.init(device="cpu")
    me = hvd.rank()
    hvd.allreduce(torch.ones(2), name="warm")
    if me == victim:
        os._exit(0)
    t0 = time.perf_counter()
    handles = [hvd.allreduce_async(torch.ones(3) * i, name=f"lost.{i}")
               for i in range(3)]
    errors = []
    for h in handles:
        try:
            hvd.synchronize(h)
            errors.append(None)
        except Exception as e:  # noqa: BLE001 — the test reads the type
            errors.append(type(e).__name__)
    waited = time.perf_counter() - t0
    # the session is dead; leave without the cooperative teardown
    hvd.runtime._state.engine._shutdown = True
    return {"errors": errors, "waited": waited}


def guard_verdict_agreement(steps):
    """Two ranks train with HOROVOD_GUARD and a ``nan`` spec poisoning
    rank 0's bucket at step 1: both ranks skip that step (the verdict
    comes from the reduced buffer) and end with identical parameters."""
    hvd.init(device="cpu")
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    verdicts = []
    x = torch.arange(12.).reshape(4, 3) / 10
    for _ in range(steps):
        opt.zero_grad()
        model(x).pow(2).mean().backward()
        opt.step()
        verdicts.append(hvd.guard.get().last_verdict["action"])
    params = [p.detach().clone() for p in model.parameters()]
    hvd.shutdown()
    return {"verdicts": verdicts, "params": params}


def rendezvous_agreement(generation, expected, straggler, settle):
    """Every rank but ``straggler`` joins rendezvous ``generation`` over
    the job's store (the straggler joins after the settle window): the
    joiners agree on the membership without it."""
    from horovod_tpu_torch.elastic.rendezvous import rendezvous
    hvd.init(device="cpu")
    me = hvd.runtime.world_rank()
    hvd.allreduce(torch.ones(1), name="rdzv.warm")
    if me == straggler:
        time.sleep(settle * 4)
        try:
            rendezvous(generation, expected, me, settle=settle, timeout=10)
            out = "joined"
        except Exception as e:  # noqa: BLE001 — the test reads the text
            out = str(e)
        return {"members": None, "straggler": out}
    members = rendezvous(generation, expected, me, settle=settle,
                         timeout=10)
    # the straggler reads the view before process 0 leaves with the store
    time.sleep(settle * 6)
    return {"members": members}


def divergence_repair():
    """Two ranks with HOROVOD_GUARD_DIVERGENCE_INTERVAL=1: rank 1's
    parameters drift; the probe finds two digests, repairs from the
    majority (the lower rank on a tie) in place, and the striped probe
    then sees one stripe-digest matrix."""
    hvd.init(device="cpu")
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    mon = hvd.guard.get()
    same = mon.check_divergence(model)
    if hvd.rank() == 1:
        with torch.no_grad():
            model.bias.add_(1e-3)
    repaired = mon.check_divergence(model)
    striped = mon.check_divergence(model, striped=True)
    out = {"same": same, "repaired": repaired is model,
           "striped": striped,
           "params": [p.detach().clone() for p in model.parameters()],
           "divergence": hvd.metrics.GUARD_DIVERGENCE.value()}
    hvd.shutdown()
    return out
