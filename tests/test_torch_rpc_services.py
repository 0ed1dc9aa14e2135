"""The port's RPC layer and driver/task services
(horovod_tpu_torch/run/rpc.py, services.py, task_fn.py) as the JAX
package's tests hold its own: HMAC framing and rejection, the codec,
ping and the service-name and key checks, the driver's registration and
its timeout message, the task service's output streaming and terminate,
the launch through the services (and its failure teardown), and a
bootstrap that exits once its driver is gone. Every wait has a bound.
The wire format is the reference's: a frame the JAX package's ``Wire``
writes reads back through the port's.

Behavioral spec: tests/test_rpc_services.py.
"""

import io
import os
import sys
import time

import pytest

from horovod_tpu.run import rpc as jrpc
from horovod_tpu_torch.run import rpc
from horovod_tpu_torch.run import services as svc
from horovod_tpu_torch.run.run import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_wire_is_the_references():
    key = rpc.make_secret_key()
    buf = io.BytesIO()
    jrpc.Wire(key).write({"hello": [1, 2, 3]}, buf)
    buf.seek(0)
    assert rpc.Wire(key).read(buf) == {"hello": [1, 2, 3]}


def test_wire_roundtrip_and_hmac_rejection():
    key = rpc.make_secret_key()
    wire = rpc.Wire(key)
    buf = io.BytesIO()
    wire.write({"hello": [1, 2, 3]}, buf)
    buf.seek(0)
    assert wire.read(buf) == {"hello": [1, 2, 3]}

    # Same frame, wrong key -> AuthenticationError before unpickling.
    buf.seek(0)
    evil = rpc.Wire(rpc.make_secret_key())
    with pytest.raises(rpc.AuthenticationError):
        evil.read(buf)


def test_codec_roundtrip():
    obj = {"a": (1, "two"), "b": [3.0]}
    assert rpc.loads_base64(rpc.dumps_base64(obj)) == obj


def test_ping_and_unknown_request():
    key = rpc.make_secret_key()
    service = rpc.BasicService("unit service", key)
    try:
        client = rpc.BasicClient("unit service", service.addresses(), key)
        resp = client.request(rpc.PingRequest())
        assert isinstance(resp, rpc.PingResponse)
        assert resp.service_name == "unit service"
    finally:
        service.shutdown()


def test_client_rejects_wrong_service_name():
    key = rpc.make_secret_key()
    service = rpc.BasicService("service A", key)
    try:
        with pytest.raises(ConnectionError):
            rpc.BasicClient("service B", service.addresses(), key,
                            probe_timeout=1, attempts=1)
    finally:
        service.shutdown()


def test_client_rejects_wrong_key():
    key = rpc.make_secret_key()
    service = rpc.BasicService("svc", key)
    try:
        with pytest.raises(ConnectionError):
            rpc.BasicClient("svc", service.addresses(),
                            rpc.make_secret_key(), probe_timeout=1,
                            attempts=1)
    finally:
        service.shutdown()


def test_driver_registration_and_host_hashes():
    key = rpc.make_secret_key()
    driver = svc.DriverService(num_hosts=2, key=key)
    try:
        client = svc.DriverClient(driver.addresses(), key)
        client.register_task(0, [("127.0.0.1", 1234)], "hash-a")
        client.register_task(1, [("127.0.0.1", 5678)], "hash-a")
        driver.wait_for_initial_registration(timeout=5)
        # the driver prepends the IP the registration arrived from (the
        # proven-routable path); the self-reported address is preserved
        addrs = client.all_task_addresses(0)
        assert ("127.0.0.1", 1234) in addrs
        assert all(port == 1234 for _, port in addrs)
        assert client.task_host_hash_indices() == {"hash-a": [0, 1]}
    finally:
        driver.shutdown()


def test_registration_timeout_message():
    key = rpc.make_secret_key()
    driver = svc.DriverService(num_hosts=1, key=key)
    try:
        with pytest.raises(TimeoutError, match="start-timeout"):
            driver.wait_for_initial_registration(timeout=0.2)
    finally:
        driver.shutdown()


def test_task_service_runs_command_streams_output():
    key = rpc.make_secret_key()
    driver = svc.DriverService(num_hosts=1, key=key)
    chunks = []
    driver.set_output_sink(chunks.append)
    task = None
    try:
        dclient = svc.DriverClient(driver.addresses(), key)
        task = svc.TaskService(0, key, dclient)
        dclient.register_task(0, task.addresses(), svc.host_hash())
        driver.wait_for_initial_registration(timeout=5)

        tclient = svc.TaskClient(driver.task_addresses_for(0), key)
        tclient.run_command(
            3, [sys.executable, "-c",
                "import os,sys; print('out', os.environ['MARKER']); "
                "print('err', file=sys.stderr); sys.exit(7)"],
            {"MARKER": "m42"})
        codes = driver.wait_for_exit_codes([3])
        assert codes == {3: 7}
        texts = {(c.stream, c.text.strip()) for c in chunks}
        assert ("stdout", "out m42") in texts
        assert ("stderr", "err") in texts
        assert all(c.rank == 3 for c in chunks)
    finally:
        if task is not None:
            task.shutdown()
        driver.shutdown()


def test_task_service_terminate_kills_process():
    key = rpc.make_secret_key()
    driver = svc.DriverService(num_hosts=1, key=key)
    task = None
    try:
        dclient = svc.DriverClient(driver.addresses(), key)
        task = svc.TaskService(0, key, dclient)
        tclient_addresses = task.addresses()
        dclient.register_task(0, tclient_addresses, svc.host_hash())
        tclient = svc.TaskClient(tclient_addresses, key)
        tclient.run_command(0, [sys.executable, "-c",
                                "import time; time.sleep(600)"], {})
        time.sleep(0.5)
        tclient.terminate()
        deadline = time.time() + 10
        while not driver.exit_codes() and time.time() < deadline:
            time.sleep(0.1)
        codes = driver.exit_codes()
        assert codes and codes[0] != 0  # killed, not clean exit
    finally:
        if task is not None:
            task.shutdown()
        driver.shutdown()


def test_launch_via_services_end_to_end():
    """Two ranks through the full RPC path; rank env must be wired."""
    code = ("import os; "
            "print('rank', os.environ['HOROVOD_TPU_PROCESS_ID'], "
            "'of', os.environ['HOROVOD_TPU_NUM_PROCESSES'])")
    rc = launch(2, [sys.executable, "-c", code], via_services=True,
                start_timeout=30)
    assert rc == 0


def test_launch_rpc_env_selects_the_services_path(monkeypatch, tmp_path):
    """``HOROVOD_LAUNCH_RPC=1`` routes a local launch through the driver
    and task services; each rank's output comes back with its prefix."""
    import subprocess
    code = ("import os; print('rank', os.environ['HOROVOD_TPU_PROCESS_ID'])")
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from horovod_tpu_torch.run.run import launch; "
         f"sys.exit(launch(2, [sys.executable, '-c', {code!r}], "
         "start_timeout=30))"],
        env=dict(__import__("os").environ, HOROVOD_LAUNCH_RPC="1"),
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "[0]<stdout>: rank 0" in out.stdout
    assert "[1]<stdout>: rank 1" in out.stdout


def test_launch_via_services_failure_teardown():
    """One rank fails fast; the other sleeps — job must not hang."""
    code = ("import os, time, sys\n"
            "if os.environ['HOROVOD_TPU_PROCESS_ID'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(600)\n")
    start = time.time()
    rc = launch(2, [sys.executable, "-c", code], via_services=True,
                start_timeout=30)
    assert rc == 3
    assert time.time() - start < 60


def test_task_fn_exits_when_driver_dies():
    """Orphan prevention: task_fn polls the driver and exits when it's gone."""
    import base64
    import subprocess

    key = rpc.make_secret_key()
    driver = svc.DriverService(num_hosts=1, key=key)
    addr_arg = ",".join(f"{ip}:{port}" for ip, port in driver.addresses())
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run.task_fn", "0", addr_arg],
        stdin=subprocess.PIPE, cwd=REPO)
    p.stdin.write(base64.b64encode(key) + b"\n")
    p.stdin.flush()
    try:
        driver.wait_for_initial_registration(timeout=30)
        driver.shutdown()
        # ping interval is 5s; allow a couple of cycles
        assert p.wait(timeout=20) is not None
    finally:
        if p.poll() is None:
            p.kill()
