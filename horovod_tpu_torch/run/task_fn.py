"""Remote bootstrap: ``python -m horovod_tpu_torch.run.task_fn <index>
<driver>`` (counterpart of horovod_tpu/run/task_fn.py).

Reference equivalent: ``python -m horovod.run.task_fn`` (run/task_fn.py) —
the snippet horovodrun launches on every host over ssh. It connects back to
the driver, registers this host's :class:`TaskService`, then idles until
the driver terminates it (or the driver becomes unreachable — periodic
pings prevent orphaned task services after an abnormal driver exit).

The per-job HMAC secret arrives on **stdin** (first line, base64) so it
never appears on a command line or in /proc/*/cmdline of either host
(reference keeps its secret off argv the same way, via the env block the
driver service itself distributes). ``HOROVOD_SECRET_KEY`` in the
environment is accepted as a fallback for programmatic use.
"""

import base64
import os
import sys
import time

_PING_INTERVAL_S = 5.0


def _read_secret():
    # stdin first: it carries THIS job's key; a HOROVOD_SECRET_KEY
    # inherited from the launcher's environment could be stale and would
    # silently fail every HMAC check. select() (zero timeout after a short
    # grace period) avoids blocking forever when a programmatic caller
    # opened a pipe but only set the env var.
    import select

    if not sys.stdin.isatty():
        # With an env fallback available, still grant stdin a short grace
        # period — the launcher's pipe write may land just after spawn and
        # must beat a stale inherited env key.
        has_env = "HOROVOD_SECRET_KEY" in os.environ
        deadline = time.time() + (1.0 if has_env else 10.0)
        while True:
            wait = max(0.0, deadline - time.time())
            ready, _, _ = select.select([sys.stdin], [], [], wait)
            if ready:
                line = sys.stdin.readline().strip()
                if line:
                    return base64.b64decode(line)
                break  # EOF / empty line -> fall through to env
            if time.time() >= deadline:
                break
    env = os.environ.get("HOROVOD_SECRET_KEY")  # hvdlint: disable=HVD003 -- secret handoff from the launcher, never a Config field
    if env:
        return base64.b64decode(env)
    raise RuntimeError(
        "No secret key on stdin and HOROVOD_SECRET_KEY is unset.")


def main(index, driver_addresses, key=None):
    from .rpc import PingRequest
    from .services import DriverClient, TaskService, host_hash

    key = key or _read_secret()
    driver = DriverClient(driver_addresses, key)
    task = TaskService(index, key, driver)
    driver.register_task(index, task.addresses(), host_hash())
    try:
        while not task.wait_for_termination(_PING_INTERVAL_S):
            try:
                driver.request(PingRequest())
            except (ConnectionError, OSError):
                # Driver is gone (crashed or torn down without reaching
                # us): kill our children and exit instead of idling as an
                # orphan holding ports on this host.
                task.terminate()
                break
    finally:
        task.shutdown()


def _parse_addresses(arg):
    # host1:port1,host2:port2
    out = []
    for item in arg.split(","):
        host, _, port = item.rpartition(":")
        out.append((host, int(port)))
    return out


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print("usage: python -m horovod_tpu_torch.run.task_fn <index> "
              "<driver_host:port[,host:port...]>  (secret key base64 on "
              "stdin)", file=sys.stderr)
        sys.exit(1)
    main(int(sys.argv[1]), _parse_addresses(sys.argv[2]))
