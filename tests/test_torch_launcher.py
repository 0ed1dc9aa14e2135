"""The port's launcher (horovod_tpu_torch/run/run.py) against the JAX
package's (horovod_tpu/run/run.py): the CLI parse and host parse over a
grid, equal; a two-process gloo collective launched on the CPU; failure
teardown; the launcher cache; the ssh check (injected, and through a
fake ``ssh`` on PATH); gang restart recovered and exhausted; the rank
environment ``runtime._join_group`` reads; and the ``python -m`` entry.

Every launched worker is tests/torch_launch_workers.py (JAX-free); every
wait is bounded by the launcher's start timeout or the test's own.

Behavioral spec: tests/test_launcher.py.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from horovod_tpu.run import run as jrun
from horovod_tpu_torch.run import parse_args
from horovod_tpu_torch.run import run as prun

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_launch_workers.py")


def _cmd(*args):
    return [sys.executable, WORKER, *map(str, args)]


def _env(**kw):
    env = dict(os.environ, HOROVOD_PROFILER_DISABLE="1")
    env.update(kw)
    return env


def test_parse_args_requires_np():
    with pytest.raises(SystemExit):
        parse_args(["python", "x.py"])


_ARGV = [
    ["-np", "4", "-H", "a:2,b:2", "--start-timeout", "10", "python",
     "train.py"],
    ["-np", "2", "--max-restarts", "3", "cmd"],
    ["-np", "2", "cmd", "--flag", "x"],
    ["-np", "4", "--elastic", "--autoscale", "--policy-interval", "2.5",
     "--min-workers", "2", "--max-workers", "6", "cmd"],
    ["-np", "1", "-p", "2222", "--disable-cache", "--verbose", "cmd"],
    ["--version"],
    ["-v"],
]


@pytest.mark.parametrize("argv", _ARGV, ids=range(len(_ARGV)))
def test_parse_args_matches_the_reference(argv):
    assert vars(parse_args(argv)) == vars(jrun.parse_args(argv))


_HOSTS = [(None, 4), ("h1:2,h2:3", 5), ("h1,h2", 2), ("h1:4", 2),
          (" a :1, b :2", 3)]


@pytest.mark.parametrize("hosts,np_", _HOSTS, ids=range(len(_HOSTS)))
def test_parse_hosts_matches_the_reference(hosts, np_):
    assert prun._parse_hosts(hosts, np_) == jrun._parse_hosts(hosts, np_)


def test_parse_hosts_too_few_slots():
    with pytest.raises(ValueError, match="slots"):
        prun._parse_hosts("h1:1", 4)


def test_rank_env_matches_the_reference():
    args = ({"PATH": "/bin"}, "h:1", 4, 3, 1, 2, 1, 2)
    assert prun._rank_env(*args) == jrun._rank_env(*args)
    assert prun._placements([("a", 2), ("b", 2)], 3) == \
        jrun._placements([("a", 2), ("b", 2)], 3)


def test_launch_two_process_collective(tmp_path):
    """Two processes join through rank 0's store and all-reduce over gloo
    on the CPU: the reference's ``mpirun -np 2`` equivalent."""
    rc = prun.launch(2, _cmd("allreduce", tmp_path), start_timeout=60,
                     env=_env())
    assert rc == 0
    for r in range(2):
        rec = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rec == {"rank": r, "size": 2, "sum": [3.0] * 4}


def test_launched_ranks_carry_the_runtime_variables(tmp_path):
    rc = prun.launch(2, _cmd("env", tmp_path), start_timeout=60, env=_env())
    assert rc == 0
    for r in range(2):
        env = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert env["HOROVOD_TPU_PROCESS_ID"] == str(r)
        assert env["HOROVOD_TPU_NUM_PROCESSES"] == "2"
        assert env["HOROVOD_TPU_LOCAL_RANK"] == str(r)
        assert env["HOROVOD_TPU_LOCAL_SIZE"] == "2"
        assert env["HOROVOD_TPU_COORDINATOR"].startswith("localhost:")
        assert env["HOROVOD_RANK"] == str(r)


def test_launch_propagates_failure_and_tears_down(tmp_path):
    """Rank 1 fails at once; rank 0 would sleep a minute: the job ends
    with the failure's code well before that."""
    script = tmp_path / "one_fails.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['HOROVOD_TPU_PROCESS_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    t0 = time.time()
    rc = prun.launch(2, [sys.executable, str(script)], start_timeout=60,
                     env=_env())
    assert rc == 3
    assert time.time() - t0 < 30


def test_cache_roundtrip_and_staleness(tmp_path):
    from horovod_tpu_torch.run.cache import Cache, parameters_hash
    from horovod_tpu.run.cache import parameters_hash as jhash
    h = parameters_hash("h1:2,h2:2", None)
    assert h == jhash("h1:2,h2:2", None)
    c = Cache(cache_folder=str(tmp_path), params_hash=h)
    assert c.get(("ssh", "h1", None)) is None
    c.put(("ssh", "h1", None), True)
    assert c.get(("ssh", "h1", None)) is True
    c2 = Cache(cache_folder=str(tmp_path), params_hash=h)
    assert c2.get(("ssh", "h1", None)) is True
    c3 = Cache(cache_folder=str(tmp_path),
               params_hash=parameters_hash("other:4", 22))
    assert c3.get(("ssh", "h1", None)) is None
    c4 = Cache(cache_folder=str(tmp_path), params_hash=h,
               staleness_minutes=0)
    c4.put(("ssh", "h2", None), True)
    time.sleep(0.01)
    assert c4.get(("ssh", "h2", None)) is None


def test_ssh_check_uses_cache(tmp_path):
    from horovod_tpu_torch.run.cache import Cache
    calls = []

    def fake_ssh(host):
        calls.append(host)
        return (0, "") if host != "bad" else (1, "boom")

    cache = Cache(cache_folder=str(tmp_path), params_hash="x")
    assert prun.check_all_hosts_ssh_successful(
        ["remote1", "remote2"], fn_cache=cache, _ssh_exec=fake_ssh)
    assert sorted(calls) == ["remote1", "remote2"]
    calls.clear()
    assert prun.check_all_hosts_ssh_successful(
        ["remote1", "remote2"], fn_cache=cache, _ssh_exec=fake_ssh)
    assert calls == []
    with pytest.raises(RuntimeError, match="SSH was not successful"):
        prun.check_all_hosts_ssh_successful(["localhost", "bad"],
                                            fn_cache=None,
                                            _ssh_exec=fake_ssh)


def test_ssh_check_runs_the_ssh_binary(tmp_path, monkeypatch, capsys):
    """The probe itself: ``ssh ... host date`` through a fake ``ssh`` on
    PATH that answers 0 for ``good`` and 255 for anything else; the bad
    host's output is printed and the check raises."""
    fake = tmp_path / "bin" / "ssh"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n"
                    "for a; do host=$prev; prev=$a; done\n"
                    "if [ \"$host\" = good ]; then date; exit 0; fi\n"
                    "echo \"no route to $host\" >&2; exit 255\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}:{os.environ['PATH']}")
    monkeypatch.setattr(prun, "SSH_RETRY_DELAY", 0.01)
    assert prun.check_all_hosts_ssh_successful(["good"], ssh_port=2222)
    with pytest.raises(RuntimeError, match="SSH was not successful"):
        prun.check_all_hosts_ssh_successful(["good", "down"])
    assert "no route to down" in capsys.readouterr().err


def test_job_code_signal_killed_rank_is_failure():
    for codes in ([0, -9], [0, 0], [0, 3, -9], []):
        assert prun._job_code(codes) == jrun._job_code(codes)
    assert prun._job_code([0, -9]) == 1


def test_main_gang_restart_recovers(tmp_path, capfd):
    """The first generation fails (a marker file records it); the
    launcher's whole-job restart brings the second up, which succeeds."""
    marker = tmp_path / "attempted"
    rc = prun.main(["-np", "2", "--max-restarts", "1",
                    *_cmd("fail_once", marker)])
    assert rc == 0
    err = capfd.readouterr().err
    assert "restarting (attempt 2/2)" in err


def test_main_gang_restart_exhausted(capfd):
    rc = prun.main(["-np", "1", "--max-restarts", "1", *_cmd("fail")])
    assert rc == 3
    assert "attempt 2/2" in capfd.readouterr().err


def test_main_config_error_fails_fast(capfd):
    rc = prun.main(["-np", "4", "-H", "localhost:1", "--max-restarts", "5",
                    "true"])
    assert rc == 1
    err = capfd.readouterr().err
    assert "Host slots" in err and "restarting" not in err


def test_main_malformed_env_max_restarts(capfd, monkeypatch):
    monkeypatch.setenv("HOROVOD_MAX_RESTARTS", "banana")
    rc = prun.main(["-np", "4", "-H", "localhost:1", "true"])
    assert rc == 1
    assert "ignoring malformed" in capfd.readouterr().err


def test_python_dash_m_entry(tmp_path):
    """``python -m horovod_tpu_torch.run``: ``--version``, and a launch."""
    out = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.run",
                          "--version"], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0
    import horovod_tpu_torch
    assert out.stdout.strip() == horovod_tpu_torch.__version__
    out = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.run",
                          "-np", "2", *_cmd("env", tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert sorted(os.listdir(tmp_path)) == ["rank0.json", "rank1.json"]


def test_a_relaunched_worker_counts_the_launchers_stamps():
    """The elastic launcher stamps a respawned slot's restart count and a
    relaunched gang's resize into the worker's environment; the worker's
    own registry counts them once (``hvd_elastic_worker_restarts_total``,
    ``hvd_elastic_resizes_total``), as the JAX package's runtime does."""
    code = ("import horovod_tpu_torch as hvd\n"
            "from horovod_tpu_torch import metrics\n"
            "hvd.init(device='cpu')\n"
            "hvd.shutdown()\n"
            "hvd.init(device='cpu')\n"
            "snap = metrics.snapshot()\n"
            "print(snap['hvd_elastic_worker_restarts_total']['values'][''],\n"
            "      snap['hvd_elastic_resizes_total']['values']"
            "['direction=\"up\"'])\n"
            "hvd.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env=_env(HOROVOD_TPU_ELASTIC_RESTARTS="2",
                                  HOROVOD_TPU_ELASTIC_RESIZED="up"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2.0", "1.0"]
