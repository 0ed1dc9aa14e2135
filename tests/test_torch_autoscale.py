"""The port's elastic launcher (``horovod_tpu_torch.run.launch_elastic``):
a preempted exit retires its slot cleanly, a whole preempted gang
returns 79, the gang resizes up through the grace drain, a victim is
drained down, a drain without grace holds the world, a burnt restart
budget is recorded as a scale-down, the launcher's own SIGTERM is
forwarded as a drain that the workers' preemption grace answers with 79,
and the churn soak's short mode (tests/torch_soak_churn.py) covers every
sample exactly once through a scale-up and a preemption.

SIGTERM reaches the launcher only after every worker has reported
itself armed (a file barrier), never after a sleep; every wait has its
own bound.

Behavioral spec: tests/test_autoscale.py (the launcher cases) and
tests/test_soak_churn.py.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

from horovod_tpu_torch.elastic.policy import AutoscalePolicy, ScaleDecision
from horovod_tpu_torch.elastic.supervisor import EX_PREEMPTED
from horovod_tpu_torch.run.run import launch_elastic, parse_args

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_launch_workers.py")


def _run_launch(np_, script, extra_env=None, **kw):
    env = dict(os.environ)
    env.pop("HOROVOD_ELASTIC_GRACE_SECONDS", None)
    env.pop("HOROVOD_ELASTIC_POLICY_DIR", None)
    env.update(extra_env or {})
    return launch_elastic(np_, [sys.executable, script], env=env,
                          start_timeout=60, **kw)


def test_launcher_preempted_exit_retires_slot_clean(tmp_path):
    script = tmp_path / "one_departs.py"
    script.write_text(textwrap.dedent("""\
        import os, sys, time
        if os.environ["HOROVOD_TPU_PROCESS_ID"] == "1":
            sys.exit(79)
        time.sleep(0.5)
        """))
    summary_path = str(tmp_path / "summary.json")
    rc = _run_launch(2, str(script), min_workers=1, worker_restarts=3,
                     restart_delay=0.1, summary_path=summary_path)
    assert rc == 0
    s = json.load(open(summary_path))
    assert s["preemptions"] == 1
    assert s["replacement_requests"] == 1
    assert s["generations"] == 1
    assert s["exit_code"] == 0


def test_launcher_whole_gang_preempted_returns_79(tmp_path):
    script = tmp_path / "all_depart.py"
    script.write_text("import sys; sys.exit(79)\n")
    rc = _run_launch(1, str(script), min_workers=1, worker_restarts=3)
    assert rc == EX_PREEMPTED


class _ScriptedPolicy:
    """Deterministic decision sequence; 'hold' forever after."""

    def __init__(self, decisions):
        self.decisions = list(decisions)
        self.resizes = 0

    def observe(self, signals, world, now=None, budget_exhausted=False):
        if self.decisions:
            return self.decisions.pop(0)
        return ScaleDecision("hold", world, "scripted: drained")

    def record_resize(self, now=None):
        self.resizes += 1


def test_launcher_autoscale_gang_resize_up(tmp_path):
    script = tmp_path / "resize_up.py"
    script.write_text(textwrap.dedent("""\
        import os, sys, time
        if os.environ.get("HOROVOD_TPU_ELASTIC_RESIZED") == "up":
            assert os.environ["HOROVOD_TPU_NUM_PROCESSES"] == "2"
            sys.exit(0)
        time.sleep(30)  # generation 1 idles until drained
        """))
    pol = _ScriptedPolicy([ScaleDecision("up", 2, "scripted growth")])
    summary_path = str(tmp_path / "summary.json")
    t0 = time.time()
    rc = _run_launch(1, str(script), min_workers=1, max_workers=2,
                     worker_restarts=0, autoscale=True, policy=pol,
                     policy_interval=0.2, summary_path=summary_path,
                     extra_env={"HOROVOD_ELASTIC_DRAIN_SECONDS": "1"})
    assert rc == 0
    assert time.time() - t0 < 30
    assert pol.resizes == 1
    s = json.load(open(summary_path))
    assert s["generations"] == 2
    assert s["final_world"] == 2
    assert [r["direction"] for r in s["resizes"]] == ["up"]


def test_launcher_autoscale_drains_victim_down(tmp_path):
    script = tmp_path / "resize_down.py"
    script.write_text(textwrap.dedent("""\
        import os, signal, sys, time
        signal.signal(signal.SIGTERM, lambda *a: os._exit(79))
        deadline = time.time() + (
            3.0 if os.environ["HOROVOD_TPU_PROCESS_ID"] == "0" else 30.0)
        while time.time() < deadline:
            time.sleep(0.05)
        sys.exit(0)
        """))
    pol = _ScriptedPolicy(
        [ScaleDecision("down", 1, "scripted drain", victim_rank=1)])
    summary_path = str(tmp_path / "summary.json")
    rc = _run_launch(2, str(script), min_workers=1, worker_restarts=0,
                     autoscale=True, policy=pol, policy_interval=0.2,
                     summary_path=summary_path,
                     extra_env={"HOROVOD_ELASTIC_GRACE_SECONDS": "5",
                                "HOROVOD_ELASTIC_DRAIN_SECONDS": "1"})
    assert rc == 0
    assert pol.resizes == 1
    s = json.load(open(summary_path))
    assert s["generations"] == 1          # in-job shrink: no relaunch
    assert s["preemptions"] == 1
    assert [r.get("victim") for r in s["resizes"]] == [1]


def test_launcher_autoscale_skips_drain_without_grace(tmp_path):
    script = tmp_path / "quick.py"
    script.write_text("import time; time.sleep(1.0)\n")
    pol = _ScriptedPolicy(
        [ScaleDecision("down", 1, "scripted drain", victim_rank=1)] * 3)
    rc = _run_launch(2, str(script), min_workers=1, worker_restarts=0,
                     autoscale=True, policy=pol, policy_interval=0.2)
    assert rc == 0
    assert pol.resizes == 0


def test_launcher_budget_exhaustion_records_scale_down(tmp_path):
    script = tmp_path / "burner.py"
    script.write_text(textwrap.dedent("""\
        import os, sys, time
        if os.environ["HOROVOD_TPU_PROCESS_ID"] == "1":
            sys.exit(75)  # transient, forever
        time.sleep(4.0)
        """))
    pol = AutoscalePolicy(min_workers=1, max_workers=2, hysteresis=99,
                          cooldown_seconds=0.0)
    summary_path = str(tmp_path / "summary.json")
    rc = _run_launch(2, str(script), min_workers=1, worker_restarts=1,
                     restart_delay=0.1, autoscale=True, policy=pol,
                     policy_interval=0.2, summary_path=summary_path)
    assert rc == 0
    s = json.load(open(summary_path))
    downs = [r for r in s["resizes"] if r["direction"] == "down"]
    assert len(downs) == 1
    assert "budget" in downs[0]["reason"]


def test_launcher_forwards_sigterm_as_drain(tmp_path):
    """SIGTERM to the launcher drains the worker process groups: each
    worker's preemption grace (``hvd.elastic.run`` with
    ``HOROVOD_ELASTIC_GRACE_SECONDS``) commits and exits 79 inside the
    drain window, and the launcher exits 143. The signal goes out once
    both workers have committed (their ready files), by which time the
    launcher's handler is installed: it installs before any spawn."""
    ready = tmp_path / "ready"
    driver = tmp_path / "driver.py"
    driver.write_text(textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {REPO!r})
        import os
        from horovod_tpu_torch.run.run import launch_elastic
        env = dict(os.environ)
        env["HOROVOD_ELASTIC_DRAIN_SECONDS"] = "5"
        env["HOROVOD_ELASTIC_GRACE_SECONDS"] = "5"
        rc = launch_elastic(
            2, [sys.executable, {WORKER!r}, "grace", {str(ready)!r}],
            env=env, start_timeout=60,
            summary_path={str(tmp_path / "s.json")!r})
        sys.exit(rc)
        """))
    p = subprocess.Popen([sys.executable, str(driver)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60
        while not all(os.path.exists(f"{ready}{r}") for r in range(2)):
            assert p.poll() is None, p.communicate()[1].decode()
            assert time.time() < deadline, "the workers never committed"
            time.sleep(0.05)
        t0 = time.time()
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 128 + signal.SIGTERM, err.decode()
    assert time.time() - t0 < 5 + 3
    assert b"draining worker process groups" in err
    assert b"planned departure committed" in out
    s = json.load(open(tmp_path / "s.json"))
    assert s["preemptions"] == 2


def test_a_preempted_worker_whose_exchange_fails_departs(tmp_path):
    """Under a gang drain every worker gets SIGTERM at once, and the first
    to leave (rank 0 among them, the store's host) fails the others'
    exchange before their next commit. A worker told to leave departs
    from its last commit (exit 79, a grace file) instead of recovering
    over a store that is gone (on the card it exited 1 and the soak
    counted one preemption short)."""
    env = dict(os.environ, HOROVOD_ELASTIC_GRACE_SECONDS="5",
               HOROVOD_ELASTIC_GRACE_DIR=str(tmp_path),
               HOROVOD_TPU_PROCESS_ID="0")
    p = subprocess.run([sys.executable, WORKER, "grace_lost"], env=env,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == EX_PREEMPTED, p.stdout + p.stderr
    assert os.path.exists(tmp_path / "grace-0.pt")
    assert "departing from the last commit" in p.stdout + p.stderr


def test_parse_args_autoscale_flags():
    args = parse_args(["-np", "4", "--elastic", "--autoscale",
                       "--policy-interval", "2.5", "cmd"])
    assert args.autoscale and args.policy_interval == 2.5
    args = parse_args(["-np", "4", "cmd"])
    assert not args.autoscale and args.policy_interval == 5.0


def test_churn_soak_short_mode(tmp_path):
    """Scale-up 2 -> 3 through the grace drain, then a preemption 3 -> 2
    with an in-job re-shard: every sample exactly once (pads as the
    replay predicts), the loss-equivalent accumulator exact, recovery
    bounded, the job clean."""
    sys.path.insert(0, TESTS)
    from torch_soak_churn import run_soak
    out = run_soak(str(tmp_path), short=True)
    summary = {k: v for k, v in out.items() if k not in ("workers",)}
    assert out["ok"], json.dumps(summary, indent=1)
    assert out["exit_code"] == 0
    assert out["launcher"]["generations"] == 2
    assert [r["direction"] for r in out["launcher"]["resizes"]] == ["up"]
    assert out["exact_once"] and out["duplicates"] == 0
    assert out["samples_covered"] == out["samples_total"] == 60
