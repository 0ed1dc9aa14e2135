"""What each gloo rank runs in tests/test_torch_analysis.py's lock
witness cases (through tests/torch_ranks.py's ``spawn_ranks``). No JAX
here, and nothing of the port at import: the witness is loaded from its
file and installed before the port is imported, so the locks the port
makes at import (the metrics registry's) are witnessed too."""

import importlib.util
import threading
from pathlib import Path

WITNESS = (Path(__file__).resolve().parents[1] / "horovod_tpu_torch"
           / "analysis" / "lockwitness.py")


def _load_witness():
    spec = importlib.util.spec_from_file_location("port_lockwitness",
                                                  WITNESS)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def witnessed_engine(steps):
    """``init()`` under the port's witness; two application threads each
    submit ``steps`` rounds of an in-place all-reduce, an allgather and a
    broadcast (the two threads' names in opposite orders) and
    synchronize them, while a third reads the metrics registry; then
    ``shutdown()``. Returns the witness's counts, its cycles as text and
    whether the engine's, the registry's and the coordinator's locks
    were among the witnessed."""
    lw = _load_witness()
    witness = lw.LockOrderWitness().install()
    try:
        import torch

        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import metrics
        hvd.init(device="cpu")
        rank, size = hvd.rank(), hvd.size()
        eng = hvd.runtime.engine()
        coord = eng._coord
        checks = {
            "engine_witnessed": type(eng._lock).__name__ == "_WitnessedLock",
            "registry_witnessed":
                type(metrics.registry()._lock).__name__ == "_WitnessedLock",
            "coordinator_witnessed": coord is not None and type(
                coord._lock).__name__ == "_WitnessedLock",
        }
        ok = []
        stop = threading.Event()

        def app(tag, order):
            for i in range(steps):
                t = torch.full((64,), float(rank + 1))
                calls = {
                    "ar": lambda: hvd.allreduce_async_(
                        t, average=False, name=f"{tag}.ar.{i}"),
                    "ag": lambda: hvd.allgather_async(
                        torch.full((2,), float(rank)), name=f"{tag}.ag.{i}"),
                    "bc": lambda: hvd.broadcast_async(
                        torch.full((3,), float(rank)), 0,
                        name=f"{tag}.bc.{i}"),
                }
                handles = {k: calls[k]() for k in order}
                outs = {k: hvd.synchronize(h) for k, h in handles.items()}
                ok.append(
                    bool((t == sum(range(1, size + 1))).all())
                    and outs["ag"].shape == (2 * size,)
                    and bool((outs["bc"] == 0).all()))

        def reader():
            while not stop.is_set():
                hvd.metrics_snapshot()
                stop.wait(0.005)

        threads = [threading.Thread(target=app, args=(tag, order.split()))
                   for tag, order in (("a", "ar ag bc"), ("b", "bc ag ar"))]
        threads.append(threading.Thread(target=reader))
        for t in threads:
            t.start()
        for t in threads[:2]:
            t.join(120)
        stop.set()
        threads[2].join(10)
        hung = any(t.is_alive() for t in threads)
        hvd.shutdown()
    finally:
        witness.uninstall()
    rep = witness.report()
    return dict(checks, locks=rep["locks"], edges=len(rep["edges"]),
                cycles=lw.format_cycles(rep),
                results_ok=not hung and len(ok) == 2 * steps and all(ok))
