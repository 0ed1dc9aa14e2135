"""Continuous-churn soak of the port: scale-up, preemption and (full
mode) loss back to back against one epoch of real data, through the
port's launcher (``horovod_tpu_torch.run.launch_elastic``).

Counterpart of tests/soak_churn.py, with the same timeline (the global
training step drives every event):

1. the gang starts at 2 workers; each worker drops a policy signal per
   step;
2. once progress crosses ``UP_AT`` the scripted policy scales **up** to
   3: the whole gang drains through the preemption grace (every worker
   commits and exits 79) and generation 2 relaunches at 3 workers from
   the grace snapshots;
3. at ``SIGTERM_AT`` one worker is preempted (SIGTERM of itself): it
   commits, announces a planned departure, and the survivors re-shard
   in the job, 3 -> 2;
4. (full mode) at ``SIGKILL_AT`` one worker is lost outright (SIGKILL of
   itself): the lost-worker detector fires and the survivor recovers
   2 -> 1.

Every step allgathers the step's sample indices and accumulates
``w += sum(indices over all ranks)`` into the elastic state; each worker
replays its committed segment history after training to predict the
exact gather multiset (the ``remainder="pad"`` repeats included), and
``exact_once`` is multiset equality against it.

The workers build their own gloo group over the job's store
(``hvd.init()`` adopts it; on a card NCCL refuses several ranks on one
card) and gather on ``SOAK_DEVICE`` (``cpu``, or ``cuda``: gloo moves
the card's tensors through the host).

Run standalone::

    python tests/torch_soak_churn.py [--full] [--device cuda] [--out F]

prints the merged job summary JSON and exits non-zero when an invariant
fails. test_torch_autoscale.py and chip_smoke.py reuse ``run_soak()``.
"""

import glob
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from horovod_tpu_torch.elastic.policy import ScaleDecision  # noqa: E402
from horovod_tpu_torch.run.run import launch_elastic  # noqa: E402


class SoakPolicy:
    """Scripted by observed training progress, not the clock: scale up
    to ``target`` once any worker's signal reports step >= ``up_at``.
    One-shot: after the resize it holds."""

    def __init__(self, up_at, target):
        self.up_at = int(up_at)
        self.target = int(target)
        self.fired = False

    def observe(self, signals, world, now=None, budget_exhausted=False):
        max_step = max((int(s.get("step", 0) or 0) for s in signals),
                       default=0)
        if (not self.fired and world < self.target
                and max_step >= self.up_at):
            return ScaleDecision("up", self.target,
                                 f"soak: step {max_step} >= {self.up_at}")
        return ScaleDecision("hold", world, "soak: hold")

    def record_resize(self, now=None):
        self.fired = True


_WORKER = """\
import sys
sys.path.insert(0, {repo!r})
import datetime, json, os, signal, time
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic, metrics
from horovod_tpu_torch.elastic import policy as _pol

N = int(os.environ["SOAK_N"])
SIGTERM_AT = int(os.environ["SOAK_SIGTERM_AT"])
SIGKILL_AT = int(os.environ.get("SOAK_SIGKILL_AT", "-1"))
PACE = float(os.environ.get("SOAK_PACE", "0.05"))
DEVICE = os.environ.get("SOAK_DEVICE", "cpu")
# Churn events arm only in the post-resize generation: generation 1
# exists to trigger the scale-up, and the stamp keeps an event step
# reached twice (before and after the resize) from firing twice.
ARMED = os.environ.get("HOROVOD_TPU_ELASTIC_RESIZED") == "up"
results_dir = os.environ["SOAK_RESULTS"]
policy_dir = os.environ.get("HOROVOD_ELASTIC_POLICY_DIR")

rank = int(os.environ["HOROVOD_TPU_PROCESS_ID"])
size = int(os.environ["HOROVOD_TPU_NUM_PROCESSES"])
dist.init_process_group(
    "gloo", store=dist.PrefixStore("soak/pg/", hvd.runtime.job_store()),
    rank=rank, world_size=size,
    timeout=datetime.timedelta(
        seconds=float(os.environ["HOROVOD_ELASTIC_TIMEOUT_SECONDS"])))
hvd.init(device="cuda:0" if DEVICE == "cuda" else "cpu")
dev = hvd.runtime.device()
pid = hvd.runtime.world_rank()

ds = hvd.data.DistributedDataset(lambda idx: np.asarray(idx), 1,
                                 num_samples=N, seed=7, prefetch=1,
                                 device="cpu")
state = elastic.State(w=torch.zeros((), dtype=torch.int64), step=0,
                      seen=torch.zeros((0,), dtype=torch.int64))
hvd.data.attach_to_state(state, ds)
# Generation 2 resumes from the drained gang's grace snapshot (the
# newest commit is the consistent rollback point); in generation 1 this
# restores the initial fields.
state.restore()
recovery = {{"t": None, "seconds": []}}


@elastic.run
def train(state):
    if recovery["t"] is not None:
        recovery["seconds"].append(time.perf_counter() - recovery["t"])
    while ds.epoch < 1:
        for batch in ds:
            step = int(state.step)
            if (ARMED and pid == 2 and hvd.size() == 3
                    and step == SIGTERM_AT):
                # Preemption: the grace ramp commits this step, announces
                # a planned departure and exits 79; peers re-shard
                # without waiting out the lost-worker timeout.
                os.kill(os.getpid(), signal.SIGTERM)
            if (ARMED and SIGKILL_AT >= 0 and pid == 1
                    and hvd.size() == 2 and step == SIGKILL_AT):
                time.sleep(0.5)  # let peers clear the previous step
                os.kill(os.getpid(), signal.SIGKILL)
            idx = torch.as_tensor(np.asarray(batch), dtype=torch.int64)
            recovery["t"] = time.perf_counter()
            everyone = hvd.allgather(idx.to(dev), name="soak.idx")
            flat = everyone.cpu().ravel()
            state.w = state.w + flat.sum()
            state.seen = torch.cat([state.seen, flat])
            state.step = step + 1
            if policy_dir:
                _pol.write_signal(policy_dir, pid, {{
                    "rank": pid, "time": time.time(),
                    "step": int(state.step), "step_seconds": PACE,
                    "skew": 1.0, "stall": 0.0}})
            state.commit()
            time.sleep(PACE)


train(state)

seen = np.sort(state.seen.numpy())
uniq = len(set(seen.tolist()))
# The committed position is a pure function of (seed, epoch, segment
# history): replay it to predict the gather multiset, pads included.
from horovod_tpu_torch.data import sharding as _sh
from horovod_tpu_torch.data.state import IteratorState as _IS
_it = _IS.from_dict(state.data_iter)
_g = _sh.epoch_permutation(N, _it.epoch, _it.seed, _it.shuffle)
_parts = []
for _size, _steps in _it.segments:
    for _r in range(_size):
        _parts.append(_sh.shard_indices(_g, _r, _size, 1)[:_steps])
    _g = _sh.remaining_after(_g, _steps, _size, 1)
expected = (np.sort(np.concatenate(_parts)) if _parts
            else np.empty(0, np.int64))
pads = int(len(expected) - N)
snap = metrics.snapshot()
rec = snap["hvd_elastic_recovery_seconds"]["values"].get(
    "", {{"count": 0, "sum": 0.0}})
resizes_down = snap["hvd_elastic_resizes_total"]["values"].get(
    'direction="down"', 0)
world_gauge = snap["hvd_elastic_world_size"]["values"].get("", -1)
result = {{
    "pid": pid,
    "world": hvd.size(),
    "world_gauge": world_gauge,
    "steps": int(state.step),
    "samples_total": N,
    "samples_covered": uniq,
    "duplicates": int(len(seen) - uniq - pads),
    "exact_once": bool(uniq == N and np.array_equal(seen, expected)),
    "pad_duplicates": pads,
    "final_w": int(state.w),
    "expected_w": int(expected.sum()),
    "recoveries": rec["count"],
    "recovery_seconds_sum": rec["sum"],
    "recovery_wall_seconds": recovery["seconds"],
    "resizes_down": resizes_down,
    "device": str(dev),
}}
path = os.path.join(results_dir, "result-%d.json" % pid)
with open(path + ".tmp", "w") as f:
    json.dump(result, f)
os.replace(path + ".tmp", path)
print("SOAKPID%dOK" % pid)
sys.stdout.flush()
hvd.shutdown()
if dist.is_initialized():  # a recovery's survivors' group is the runtime's
    dist.destroy_process_group()
if pid == 0:
    # pid 0 hosts the job's store: outlive the peers' teardown so their
    # client does not see it go mid-exit.
    time.sleep(1.5)
"""


def run_soak(tmp_dir, short=True, recovery_bound=10.0, device="cpu"):
    """One churn-soak run under ``tmp_dir``; returns the merged summary
    (launcher summary + per-worker coverage + pass/fail fields). Raises
    nothing: callers assert on the returned fields."""
    tmp_dir = os.path.abspath(tmp_dir)
    results_dir = os.path.join(tmp_dir, "results")
    grace_dir = os.path.join(tmp_dir, "grace")
    os.makedirs(results_dir, exist_ok=True)
    summary_path = os.path.join(tmp_dir, "job-summary.json")
    script = os.path.join(tmp_dir, "soak_worker.py")
    with open(script, "w") as f:
        f.write(_WORKER.format(repo=REPO))

    n = 60 if short else 90
    env = dict(os.environ)
    env.pop("HOROVOD_STALL_CHECK_TIME_SECONDS", None)
    env.update({
        "HOROVOD_ELASTIC": "1",
        "HOROVOD_ELASTIC_TIMEOUT_SECONDS": "2",
        "HOROVOD_ELASTIC_SETTLE_SECONDS": "0.5",
        "HOROVOD_ELASTIC_GRACE_SECONDS": "8",
        "HOROVOD_ELASTIC_GRACE_DIR": grace_dir,
        "HOROVOD_ELASTIC_DRAIN_SECONDS": "3",
        "HOROVOD_STALL_CHECK_TIME_SECONDS": "60",
        "HOROVOD_PROFILER_DISABLE": "1",
        "SOAK_N": str(n),
        "SOAK_SIGTERM_AT": "14",
        "SOAK_SIGKILL_AT": "-1" if short else "18",
        "SOAK_PACE": "0.05",
        "SOAK_RESULTS": results_dir,
        "SOAK_DEVICE": device,
    })

    t0 = time.time()
    rc = launch_elastic(
        2, [sys.executable, script], env=env, start_timeout=60,
        min_workers=1, max_workers=3, worker_restarts=0,
        autoscale=True, policy=SoakPolicy(up_at=4, target=3),
        policy_interval=0.3, summary_path=summary_path)
    elapsed = time.time() - t0

    launcher = {}
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            launcher = json.load(f)
    workers = []
    for path in sorted(glob.glob(os.path.join(results_dir,
                                              "result-*.json"))):
        with open(path) as f:
            workers.append(json.load(f))

    expected_world = 2 if short else 1
    resize_dirs = [r["direction"] for r in launcher.get("resizes", [])]
    out = {
        "mode": "short" if short else "full",
        "device": device,
        "exit_code": rc,
        "elapsed_seconds": elapsed,
        "launcher": launcher,
        "workers": workers,
        # exact-once coverage
        "samples_total": n,
        "samples_covered": max((w["samples_covered"] for w in workers),
                               default=0),
        "duplicates": max((w["duplicates"] for w in workers), default=-1),
        "exact_once": bool(workers) and all(w["exact_once"]
                                            for w in workers),
        "final_loss_ok": bool(workers) and all(
            w["final_w"] == w["expected_w"] for w in workers),
        # churn shape
        "scaled_up": "up" in resize_dirs,
        "preemptions": launcher.get("preemptions", 0),
        "final_world_ok": bool(workers) and all(
            w["world"] == expected_world for w in workers),
        # every in-job recovery (planned departure or loss) under the bound
        "recovery_bounded": bool(workers) and all(
            w["recovery_seconds_sum"]
            <= max(w["recoveries"], 1) * recovery_bound
            for w in workers),
        "recoveries": max((w["recoveries"] for w in workers), default=0),
    }
    out["ok"] = bool(
        rc == 0
        and out["exact_once"]
        and out["final_loss_ok"]
        and out["duplicates"] == 0
        and out["samples_covered"] == n
        and out["scaled_up"]
        # 2 grace drains (the gang resize) + 1 preemption
        and out["preemptions"] >= 3
        and out["final_world_ok"]
        and out["recovery_bounded"]
        and out["recoveries"] >= (1 if short else 2))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    short = "--full" not in argv
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cpu"
    out_path = argv[argv.index("--out") + 1] if "--out" in argv else None
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hvd-soak-") as tmp:
        out = run_soak(tmp, short=short, device=device)
    blob = json.dumps(out, indent=2, sort_keys=True)
    # worker output streams through this process's stdout too, so a
    # harness parses the --out file, not the mixed stream
    print(blob)
    if out_path:
        with open(out_path, "w") as f:
            f.write(blob + "\n")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
