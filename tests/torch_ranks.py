"""Multi-process gloo ranks for the port's tests.

A rank of horovod_tpu_torch is a process. ``spawn_ranks(n, fn, *args)``
runs ``fn(*args)`` in ``n`` processes on the CPU, each started with the
JAX package's launcher variables (``HOROVOD_TPU_COORDINATOR`` on a free
localhost port, ``HOROVOD_TPU_NUM_PROCESSES``, ``HOROVOD_TPU_PROCESS_ID``
and the local rank and size), so that ``hvd.init(device="cpu")`` inside
``fn`` joins one gloo group; it returns the ranks' return values in rank
order. ``fn`` is a module-level function of a module this directory can
import, and that module should not import JAX: each process imports it,
and spawning already costs seconds. ``launch_ranks`` is the lower level:
``n`` processes of one Python command line.
"""

import os
import pickle
import random
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent

_BOOT = r'''
import importlib
import os
import pickle
import sys

import torch

sys.path.insert(0, sys.argv[1])
torch.set_num_threads(1)
with open(sys.argv[2], "rb") as f:
    module, name, args = pickle.load(f)
out = getattr(importlib.import_module(module), name)(*args)
rank = int(os.environ["HOROVOD_TPU_PROCESS_ID"])
with open(os.path.join(sys.argv[3], f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
'''


def free_port():
    """A free port below the kernel's ephemeral range (32768 and up on
    Linux), for a job's TCPStore. A port the kernel handed out to probe
    (bind to 0) is free again once the probe closes, and another job's
    gloo pairs, which listen on ephemeral ports, could take it before the
    store binds it; below the range only another job's store competes,
    and a random pick makes that rare."""
    rng = random.Random()
    for _ in range(100):
        port = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(n, argv, env=None, timeout=120, exits=None):
    """Run ``python *argv`` as ranks 0..n-1 of one job (from the repo
    root) and wait for all of them; returns their logs. Raises with
    every log when one fails, and kills the rest when one hangs.
    ``exits`` maps a rank to the return code it must end with instead
    of 0 (a rank a test kills: ``-signal.SIGKILL``)."""
    exits = exits or {}
    port = free_port()
    procs = []
    for r in range(n):
        penv = dict(os.environ, **(env or {}),
                    HOROVOD_TPU_COORDINATOR=f"127.0.0.1:{port}",
                    HOROVOD_TPU_NUM_PROCESSES=str(n),
                    HOROVOD_TPU_PROCESS_ID=str(r),
                    HOROVOD_TPU_LOCAL_RANK=str(r),
                    HOROVOD_TPU_LOCAL_SIZE=str(n))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=REPO, env=penv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != exits.get(r, 0) for r, p in enumerate(procs)):
        raise RuntimeError(
            f"a rank failed (return codes "
            f"{[p.returncode for p in procs]}, expected {exits or 0}):\n"
            + "\n".join(logs))
    return logs


def spawn_ranks(n, fn, *args, env=None, timeout=120, exits=None):
    """``[fn(*args) on rank r for r in range(n)]``, each rank a process
    (module docstring). ``args`` and the return values travel pickled.
    A rank listed in ``exits`` (see :func:`launch_ranks`) returns None."""
    with tempfile.TemporaryDirectory(prefix="torch-ranks-") as out:
        call = os.path.join(out, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn.__module__, fn.__name__, args), f)
        launch_ranks(n, ["-c", _BOOT, str(TESTS), call, out], env=env,
                     timeout=timeout, exits=exits)
        results = []
        for r in range(n):
            path = os.path.join(out, f"rank{r}.pkl")
            if r in (exits or {}) and not os.path.exists(path):
                results.append(None)
                continue
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
