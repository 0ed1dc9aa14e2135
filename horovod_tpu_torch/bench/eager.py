"""Eager (op-at-a-time) data-plane throughput of the engine.

Counterpart of bench_eager.py: the reference's motivating workload —
many small gradient tensors submitted op-at-a-time, the reason its
fusion buffer exists (fusion_buffer_manager.{h,cc}) — through
``hvd.allreduce_async`` / ``hvd.synchronize`` (ops/engine.py), with
fusion and the response cache toggled, plus a broadcast of a model's
tensors. Reports wire MB/s: payload bytes x ranks / wall time (on a card,
after the card has finished the round).

    python -m horovod_tpu_torch.bench.eager [--device cpu]

Emits one JSON line (the last of its output), under bench_eager.py's
metric name:

    {"metric": "eager_allreduce_mbytes_sec", "value": N, "unit": "MB/s",
     "vs_baseline": fused_over_unfused_speedup, "configs": {...},
     "device": ..., "card": "<name>, <power limit>"}

``--multihost N`` is bench_eager.py's control-plane run: N worker
processes through the port's launcher (run/run.py), each submitting
``--tensors`` small all-reduces a step and synchronizing them, with the
coordinator's epoch-token bypass off and then on; process 0 prints

    {"metric": "eager_multihost_cycle_ms", "value": ms_per_step_bypass_on,
     "vs_baseline": off_over_on, "configs": {...}, "processes": N,
     "backend": "gloo", ...}

The ranks share one card (or the CPU) over gloo, which moves card
tensors through the host: the cycle time is a control-plane time
(negotiation through the job's store, plus gloo), not an NCCL one.
"""

import argparse
import datetime
import json
import os
import sys
import time

import numpy as np
import torch

from .. import hardware, runtime

CONFIGS = {
    "fused_cached": dict(fusion_threshold=64 * 1024 * 1024,
                         cache_capacity=1024),
    "fused_nocache": dict(fusion_threshold=64 * 1024 * 1024,
                          cache_capacity=0),
    "unfused_cached": dict(fusion_threshold=1, cache_capacity=1024),
    "unfused_nocache": dict(fusion_threshold=1, cache_capacity=0),
}


def _session(device, fusion_threshold=None, cache_capacity=None):
    """A fresh runtime session with the engine knobs set."""
    for knob, value in (("HOROVOD_FUSION_THRESHOLD", fusion_threshold),
                        ("HOROVOD_CACHE_CAPACITY", cache_capacity)):
        if value is None:
            os.environ.pop(knob, None)
        else:
            os.environ[knob] = str(value)
    runtime.shutdown()
    runtime.init(device=device)


def _finish(device):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def run_eager_bench(device, num_tensors=128, elems=1024, repeats=5,
                    fusion_threshold=None, cache_capacity=None):
    """Submit ``num_tensors`` float32 tensors of ``elems`` elements,
    synchronize all, ``repeats`` times after one warm-up round. Returns
    aggregate wire MB/s (payload bytes x ranks / wall time)."""
    import horovod_tpu_torch as hvd
    _session(device, fusion_threshold, cache_capacity)
    dev = runtime.device()
    n = hvd.size()
    data = [torch.from_numpy(np.random.RandomState(i).randn(elems)
                             .astype(np.float32)).to(dev)
            for i in range(num_tensors)]
    nbytes_round = num_tensors * elems * 4 * n

    def one_round(tag):
        handles = [hvd.allreduce_async(t, average=False, name=f"eb.{tag}.{i}")
                   for i, t in enumerate(data)]
        for h in handles:
            hvd.synchronize(h)

    one_round("warm")
    _finish(device)
    t0 = time.perf_counter()
    for r in range(repeats):
        one_round(f"r{r}")
    _finish(device)
    dt = time.perf_counter() - t0
    runtime.shutdown()
    return nbytes_round * repeats / dt / 1e6


def run_broadcast_bench(device, num_tensors=16, elems=262144, repeats=5):
    """broadcast_parameters-style workload: root fans a model's tensors
    out to every rank. Reports payload MB/s (one tensor copy a round)."""
    import horovod_tpu_torch as hvd
    _session(device)
    dev = runtime.device()
    data = [torch.from_numpy(np.random.RandomState(i).randn(elems)
                             .astype(np.float32)).to(dev)
            for i in range(num_tensors)]
    nbytes_round = num_tensors * elems * 4

    def one_round(tag):
        handles = [hvd.broadcast_async(t, 0, name=f"bb.{tag}.{i}")
                   for i, t in enumerate(data)]
        for h in handles:
            hvd.synchronize(h)

    one_round("warm")
    _finish(device)
    t0 = time.perf_counter()
    for r in range(repeats):
        one_round(f"r{r}")
    _finish(device)
    dt = time.perf_counter() - t0
    runtime.shutdown()
    return nbytes_round * repeats / dt / 1e6


def run(device, num_tensors=128, elems=1024, repeats=5):
    """The bench's result dict (its JSON line)."""
    results = {}
    for name, cfg in CONFIGS.items():
        results[name] = run_eager_bench(device, num_tensors, elems, repeats,
                                        **cfg)
        print(f"# {name}: {results[name]:.2f} MB/s", file=sys.stderr)
    results["broadcast"] = run_broadcast_bench(device, repeats=repeats)
    print(f"# broadcast: {results['broadcast']:.2f} MB/s payload",
          file=sys.stderr)
    speedup = (results["fused_cached"] / results["unfused_nocache"]
               if results["unfused_nocache"] else 0.0)
    return {"metric": "eager_allreduce_mbytes_sec",
            "value": results["fused_cached"], "unit": "MB/s",
            "vs_baseline": speedup, "configs": results,
            "num_tensors": num_tensors, "elems": elems, "device": device,
            "card": hardware.card_line() if device.startswith("cuda")
            else None}


def _mh_worker_phase(device, tag, num_tensors, elems, steps):
    """One steady-state measurement phase inside a launched worker:
    submit ``num_tensors`` small allreduces a step, synchronize all,
    repeat. Returns (cycle_latency_ms, mbytes_sec, publish_bytes)."""
    import horovod_tpu_torch as hvd
    hvd.init(device=device)
    dev = runtime.device()
    n = hvd.size()
    data = [torch.from_numpy(np.random.RandomState(i).randn(elems)
                             .astype(np.float32)).to(dev)
            for i in range(num_tensors)]

    def one_step(s):
        handles = [hvd.allreduce_async(t, average=False,
                                       name=f"mh.{tag}.{s}.{i}")
                   for i, t in enumerate(data)]
        for h in handles:
            hvd.synchronize(h)

    one_step("warm")
    _finish(device)
    t0 = time.perf_counter()
    for s in range(steps):
        one_step(s)
    _finish(device)
    dt = time.perf_counter() - t0
    st = runtime.live_state().stats
    publish_bytes = sum(sz * cnt for sz, (cnt, _)
                        in st.histogram("gather").items())
    hvd.shutdown()
    return (dt / steps * 1e3,
            num_tensors * elems * 4 * n * steps / dt / 1e6,
            publish_bytes)


def _mh_worker(device, num_tensors, elems, steps):
    """Launched worker: a gloo group of its own over the job's store
    (``init()`` adopts it; several ranks share one card, which NCCL
    refuses), then the phase with the bypass off, then on; process 0
    prints the JSON line."""
    import torch.distributed as dist
    rank = int(os.environ["HOROVOD_TPU_PROCESS_ID"])  # hvdlint: disable=HVD003 -- launcher-worker protocol var
    size = int(os.environ["HOROVOD_TPU_NUM_PROCESSES"])  # hvdlint: disable=HVD003 -- launcher-worker protocol var
    if device.startswith("cuda"):
        device = "cuda:0"
    dist.init_process_group(
        "gloo", store=dist.PrefixStore("bench/mh/pg/", runtime.job_store()),
        rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=120))
    os.environ["HOROVOD_COORDINATOR_BYPASS_DISABLE"] = "1"
    lat_off, mbs_off, pub_off = _mh_worker_phase(device, "off", num_tensors,
                                                 elems, steps)
    os.environ.pop("HOROVOD_COORDINATOR_BYPASS_DISABLE")  # hvdlint: disable=HVD003 -- the bench sets and clears the knob around its own phase; init reads it through Config
    lat_on, mbs_on, pub_on = _mh_worker_phase(device, "on", num_tensors,
                                              elems, steps)
    if rank == 0:
        print(json.dumps({
            "metric": "eager_multihost_cycle_ms",
            "value": lat_on,
            "unit": "ms/step",
            "vs_baseline": lat_off / max(lat_on, 1e-9),
            "configs": {
                "bypass_off": {"cycle_ms": lat_off, "mbytes_sec": mbs_off,
                               "publish_bytes": pub_off},
                "bypass_on": {"cycle_ms": lat_on, "mbytes_sec": mbs_on,
                              "publish_bytes": pub_on},
            },
            "num_tensors": num_tensors,
            "processes": size,
            "backend": "gloo",
            "device": device,
            "card": hardware.card_line() if device.startswith("cuda")
            else None,
            "note": "control-plane time over gloo, not NCCL",
        }), flush=True)
    dist.destroy_process_group()


def run_multihost(nproc, device, num_tensors=200, elems=1024, steps=10,
                  env=None):
    """Launch ``nproc`` workers through the port's launcher; returns the
    launcher's exit code (process 0's JSON line is in its output)."""
    from ..run.run import launch
    env = dict(os.environ if env is None else env)
    env.setdefault("HOROVOD_PROFILER_DISABLE", "1")
    return launch(nproc, [sys.executable, "-m", "horovod_tpu_torch.bench."
                          "eager", "--mh-worker", "--device", device,
                          "--tensors", str(num_tensors), "--elems",
                          str(elems), "--steps", str(steps)],
                  start_timeout=120, env=env)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tensors", type=int, default=None)
    ap.add_argument("--elems", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--multihost", type=int, default=0, metavar="N",
                    help="run the control-plane benchmark across N "
                         "processes through the launcher")
    ap.add_argument("--mh-worker", action="store_true",
                    help=argparse.SUPPRESS)  # a launched worker
    args = ap.parse_args(argv)
    if args.mh_worker:  # run_multihost passes every size
        _mh_worker(args.device, args.tensors, args.elems, args.steps)
        return
    if args.multihost:
        sys.exit(run_multihost(args.multihost, args.device,
                               args.tensors or 200, args.elems, args.steps))
    if args.tensors is None:
        args.tensors = 128
    if args.device.startswith("cuda"):
        print(hardware.card_line(), flush=True)
    print(json.dumps(run(args.device, args.tensors, args.elems,
                         args.repeats)), flush=True)


if __name__ == "__main__":
    main()
