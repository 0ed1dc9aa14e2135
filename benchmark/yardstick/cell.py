"""One run of one cell: set-up, the timed window, the traced window,
the reference, the verdict and the result line.

A cell on one chip runs in this process. A cell on several chips runs
one worker process a card (this module again, ``--worker``), joined
over NCCL at a local address; the workers report to this process, which
then runs the reference on the first card, once they have exited.

Set-up (counted in ``setup_s``, from the process's start):

1. the weights and the cell's batches, made on the device from the seed;
2. the traffic's entry builds the step (``entries/<entry>.py``);
3. the first ``check_steps`` steps, through that same step object, each
   on its own batch: their losses, the first and second gradients as
   the optimizer got them (the second, a replay's where the step is
   replayed), and the parameters' change after the last (the numbers
   :mod:`yardstick.judge` compares);
4. one more step, timed, which sets how many steps fill ``--seconds``.

The timed window then runs those steps back to back, at most two in
flight, each on the next batch, an event after each; it ends with a
synchronize. With ``--trace 1`` a traced window of ``trace_steps``
steps follows, after a one-step window that lets a replayed program map
its kernels to phases; the per-layer metrics read it
(``metrics/<name>.py``).
"""

import argparse
import gc
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import torch

from . import arith, imports, judge, kineto, peaks, spec, traffic, weights

RESULT_TAG = "BENCH_WORKER_RESULT "
WORKER_TIMEOUT_S = 330
#: The readings a rank's check steps give (:meth:`Rank.check`).
READINGS = ("losses", "grad_norms", "grad2_norms", "change_norms")


def process_start():
    """Wall-clock time at which this process started: its start in clock
    ticks after boot (``/proc/self/stat``) against the boot clock, else
    now."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) \
            - ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return time.time()


def parse(argv=None):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # The checkout holding BENCHMARK.json (default: the one this file is
    # in) and the device ("cpu" runs the program's plain kernels and skips
    # the look for a card; only the benchmark's own tests use it).
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # A worker of a cell on several chips (started by the run itself).
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--t-start", type=float, default=None)
    # A worker that only reads the program's first steps, for each of
    # these seeds (benchmark/calibrate.py).
    ap.add_argument("--seeds", default=None)
    return ap.parse_args(argv)


def _say(*parts):
    print(*parts, file=sys.stderr, flush=True)


# ------------------------------------------------------------ the program

def port_config(tfm, cfg):
    """The program's ``TransformerConfig`` of a configuration file; raises
    where the program fixes a size the file states otherwise."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    prec = cfg["precision"]
    out = tfm.TransformerConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"],
        n_layers=cfg["n_layers"], d_ff=cfg["d_ff"], max_seq=cfg["max_seq"],
        dtype=dtypes[prec["activations"]],
        param_dtype=dtypes[prec["parameters"]],
        attention_impl=cfg["attention_impl"], positional=cfg["positional"],
        loss_chunk=cfg["loss_chunk"], remat=cfg["remat"],
        moe_layers=tuple(cfg["moe_layers"]),
        moe_num_experts=cfg["moe_num_experts"], moe_top_k=cfg["moe_top_k"])
    fixed = {"moe_capacity_factor": out.moe_cfg.capacity_factor,
             "moe_aux_coef": tfm.MOE_AUX_COEF}
    for key, value in fixed.items():
        if value != cfg[key]:
            raise ValueError(f"the program fixes {key} at {value}; the "
                             f"configuration states {cfg[key]}")
    return out


class _Clock:
    """Step boundaries: CUDA events on a card, the host clock on the CPU
    (where every step has finished when it returns)."""

    def __init__(self, cuda):
        self.cuda = cuda

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _counters(hvd):
    """Program-cache misses plus step fallbacks, as the program counts
    them."""
    snap = hvd.metrics_snapshot()
    return sum(sum(snap[f]["values"].values()) for f in
               ("hvd_step_program_cache_misses", "hvd_step_fallback_total"))


def _card_line(index):
    tool = shutil.which("nvidia-smi")
    if tool is None:
        return None
    out = subprocess.run(
        [tool, f"--id={index}", "--query-gpu=name,power.limit,power.draw,"
         "clocks.sm,clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False)
    return out.stdout.strip() or None


class Rank:
    """The program on one rank for one seed: the model made from the
    seed's weights, the traffic's entry around it, and the rank's
    batches."""

    def __init__(self, hvd, tfm, bench, cfg, mix, seed, rank, dev,
                 stages=None):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        stages = [] if stages is None else stages
        tree, _ = weights.make(cfg, seed, dev)
        stages.append(("weights", time.time()))
        self.model = tfm.TransformerLM(port_config(tfm, cfg), params=tree,
                                       device=dev)
        stages.append(("model", time.time()))
        self.xs, self.ys = traffic.batches(mix, cfg["vocab_size"], seed,
                                           rank, dev)
        stages.append(("batches", time.time()))
        self.entry = bench.entry(mix["entry"])
        self.step, self.opt = self.entry.build(hvd, self.model,
                                               cfg["optimizer"])
        stages.append(("entry", time.time()))
        self.tracer = None

    def run(self, i):
        """Step ``i``, on batch ``i`` modulo the mix's batches."""
        if self.tracer is not None and not self.entry.TICKS_TRACER:
            self.tracer.tick(owner=self)
        b = i % self.mix["batches"]
        return self.step(self.xs[b], self.ys[b])

    def check(self):
        """The first ``check_steps`` steps and the readings
        :mod:`yardstick.judge` compares (:data:`READINGS`).

        AdamW's first moment gives the gradients it got: ``m1 = (1 -
        b1) g1`` after step 1, ``m2 = b1 m1 + (1 - b1) g2`` after step 2.
        ``m1`` waits on the host meanwhile, so that the device's peak
        stays the program's own."""
        leaves = weights.named_leaves(self.model.params)
        beta1 = self.cfg["optimizer"]["betas"][0]
        losses, grad_norms, grad2_norms, held = [], None, None, None
        self.step_s = []
        for i in range(self.mix["check_steps"]):
            t0 = time.perf_counter()
            losses.append(float(self.run(i)))
            self.step_s.append(time.perf_counter() - t0)
            moments = {k: self.opt.state[p]["exp_avg"]
                       for k, p in leaves.items()}
            if i == 0:
                grad_norms = {k: float(m.norm()) / (1 - beta1)
                              for k, m in moments.items()}
                held = {k: m.to("cpu", copy=True) for k, m in moments.items()}
            elif i == 1:
                grad2_norms = {
                    k: float((m - beta1 * held.pop(k).to(m.device)).norm())
                    / (1 - beta1) for k, m in moments.items()}
        _, start = weights.make(self.cfg, self.seed, self.dev)
        with torch.no_grad():
            changes = {k: float((p - start[k]).norm())
                       for k, p in leaves.items()}
        return {"losses": losses, "grad_norms": grad_norms,
                "grad2_norms": grad2_norms, "change_norms": changes}

    def close(self):
        del self.step, self.opt, self.model, self.xs, self.ys
        self.tracer = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def _session(device):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    hvd.init(device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    return hvd, tfm, dev


def readings(bench, name, seeds, rank, device):
    """The program's correctness readings for each of ``seeds``:
    ``[{"seed", "readings"}]``. One rank alone takes a session a seed: a
    replayed step's graph pool lives as long as its session, and the
    next seed's eager first step needs that memory. Several ranks keep
    one session (their eager steps capture nothing)."""
    cell = bench.cell(name)
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    alone = cell["chips"] == 1
    hvd, tfm, dev = _session(device)
    out = []
    for seed in seeds:
        prog = Rank(hvd, tfm, bench, cfg, mix, seed, rank, dev)
        out.append({"seed": seed, "readings": prog.check()})
        prog.close()
        if alone:
            hvd.shutdown()
            hvd.init(device=device)
    hvd.shutdown()
    return out


def drive(bench, name, seed, seconds, trace, rank, world, device, t_start):
    """Set-up, window and traced window of one rank; the rank's report
    (a JSON-able dict). The program's state is gone when it returns."""
    cell = bench.cell(name)
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    stages = [("start", t_start), ("interpreter and torch", time.time())]
    hvd, tfm, dev = _session(device)
    stages.append(("the program's import and init", time.time()))
    cuda = dev.type == "cuda"
    clock = _Clock(cuda)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    prog = Rank(hvd, tfm, bench, cfg, mix, seed, rank, dev, stages)
    run = prog.run
    # the peak from here on: the first step's eager run and its capture
    # (a replayed graph's activations are allocated then, in its private
    # pool; a replay allocates nothing), the window's steps
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    check = prog.check()
    stages.append(("check steps " + ", ".join(f"{s:.3f}" for s in prog.step_s)
                  + " s and readings", time.time()))
    # one more step sets the window's length
    i = mix["check_steps"]
    a = clock.mark()
    run(i)
    b = clock.mark()
    sync()
    est = torch.tensor([clock.ms(a, b) / 1e3], dtype=torch.float64,
                       device=dev)
    if world > 1:
        torch.distributed.all_reduce(est, op=torch.distributed.ReduceOp.MAX)
    n = max(2, round(seconds / float(est)))
    stages.append(("one more step", time.time()))
    _say(f"# set-up of rank {rank}: " + "; ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b)
        in zip(stages, stages[1:])))
    card = _card_line(dev.index) if cuda else None
    if card:
        _say(f"# card {rank} before the window: {card}")

    # the timed window
    sync()
    if world > 1:
        torch.distributed.barrier()
        sync()
    misses = _counters(hvd)
    t0_wall, t0 = time.time(), time.perf_counter()
    marks, window_losses = [clock.mark()], []
    for k in range(n):
        window_losses.append(run(i + 1 + k))
        marks.append(clock.mark())
        if k:
            clock.wait(marks[-2])
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    misses = _counters(hvd) - misses
    step_ms = [clock.ms(a, b) for a, b in zip(marks, marks[1:])]
    failed = int((~torch.isfinite(torch.stack(window_losses).float())).sum())
    i += 1 + n
    card = _card_line(dev.index) if cuda else None
    if card:
        _say(f"# card {rank} after the window: {card}")
    report = {
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "window_start": t0_wall, "window_s": wall, "steps": n,
        "step_ms": step_ms, "tokens_per_step": mix["batch"] * mix["seq"],
        "peak_bytes": peak, "failed": failed, "readings": check,
    }

    if trace:
        diag = tempfile.mkdtemp(prefix="bench-trace-")
        try:
            tracer = prog.tracer = hvd.trace_steps(1, out_dir=diag)
            run(i)
            if tracer.active:
                tracer.stop()
            tracer = prog.tracer = hvd.trace_steps(mix["trace_steps"],
                                                   out_dir=diag)
            marks = []
            for k in range(mix["trace_steps"]):
                run(i + 1 + k)
                marks.append(clock.mark())
                if k:
                    clock.wait(marks[-2])
            if tracer.active:
                tracer.stop()
            report.update(_per_layer(bench, cell, cfg, mix, world, tracer,
                                     peak, misses))
        finally:
            shutil.rmtree(diag, ignore_errors=True)

    prog.close()
    hvd.shutdown()
    return report


def _per_layer(bench, cell, cfg, mix, world, tracer, peak, misses):
    """The per-layer metrics of one rank's traced window, and the
    device's busy time, window and breakdown."""
    events = kineto.load(tracer.last_dir)
    win = kineto.window(events)
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=mix, cell=cell["name"], world=world,
        batch=mix["batch"], seq=mix["seq"],
        tokens_per_step=mix["batch"] * mix["seq"], steps=mix["trace_steps"],
        summary=tracer.last_summary, events=events, window=win,
        window_s=(win[1] - win[0]) * kineto.US if win else 0.0,
        busy_s=kineto.busy(events, win) if win else 0.0,
        peak_bytes=peak, program_misses=misses,
        peaks=peaks.of(torch.cuda.get_device_name()
                       if torch.cuda.is_available() else None))
    values = {}
    for m in bench.per_layer(cell["name"]):
        value = bench.metric(m["name"]).read(ctx)
        if value is not None:
            values[m["name"]] = float(value)
    by_name = {}
    for k, v in kineto.time_by_name(events).items():
        short = kineto.short_name(k)
        by_name[short] = by_name.get(short, 0.0) + v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"layer": values, "busy_s": ctx.busy_s,
            "trace_window_s": ctx.window_s,
            "device_ops": [[k, v] for k, v in top[:10]], "kernels": top,
            "idle_gaps": kineto.idle_gaps(events, win) if win else []}


# ------------------------------------------------------------- the workers

def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args, world, t_start, extra=()):
    """Run the cell's ranks, one worker process a card (``extra``: more
    arguments for each); their reports in rank order, or None when any
    worker failed."""
    port = _free_port()
    outs = tempfile.mkdtemp(prefix="bench-workers-")
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ,
                       HOROVOD_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       HOROVOD_TPU_NUM_PROCESSES=str(world),
                       HOROVOD_TPU_PROCESS_ID=str(rank),
                       HOROVOD_TPU_LOCAL_RANK=str(rank),
                       HOROVOD_TPU_LOCAL_SIZE=str(world))
            cmd = [sys.executable,
                   str(Path(__file__).resolve().parents[1] / "run.py"),
                   "--worker", "--rank", str(rank), "--t-start", repr(t_start),
                   "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", repr(args.seconds), "--trace", str(args.trace),
                   "--root", args.root, "--device", args.device, *extra]
            # standard output to a file: a pipe left unread while another
            # rank is awaited could fill and stall its writer
            with open(os.path.join(outs, f"{rank}.out"), "w") as f:
                procs.append(subprocess.Popen(cmd, env=env, stdout=f))
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        for proc in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
        reports = []
        for rank, proc in enumerate(procs):
            with open(os.path.join(outs, f"{rank}.out")) as f:
                lines = [ln for ln in f.read().splitlines()
                         if ln.startswith(RESULT_TAG)]
            if proc.returncode != 0 or not lines:
                _say(f"worker {rank} failed (exit {proc.returncode})")
                return None
            reports.append(json.loads(lines[-1][len(RESULT_TAG):]))
    except subprocess.TimeoutExpired:
        _say("a worker passed its time limit")
        return None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(outs, ignore_errors=True)
    return reports


# --------------------------------------------------------------- the run

def follow(bench, cfg, mix, seed, world, device, stale=False, **kw):
    """The plain reference through the cell's first steps, on
    ``device``, from the same seed-made inputs; ``kw`` goes to its
    ``train`` (another precision, ranks not averaged, fewer rows). With
    ``stale`` every step takes the first step's batch (a replay whose
    inputs are never copied in). Its readings a rank, in the program's
    form."""
    ref = bench.reference(cfg["reference"])
    data = []
    for rank in range(world):
        xs, ys = traffic.batches(mix, cfg["vocab_size"], seed, rank, device)
        data.append([(xs[0 if stale else i], ys[0 if stale else i])
                     for i in range(mix["check_steps"])])
    _, named = weights.make(cfg, seed, device)
    return ref.train(named, lambda n: weights.tree(n, cfg), data, cfg,
                     cfg["optimizer"], **kw)


def reference_readings(bench, cfg, mix, seed, world, device, devices=None):
    """The reference's readings, as :func:`judge.checks` takes them."""
    out = follow(bench, cfg, mix, seed, world, device, devices=devices)
    return {"losses": out["losses"], "grad_norms": out["grad_norms"][0],
            "grad2_norms": out["grad2_norms"][0],
            "change_norms": out["change_norms"][0]}


def _end_to_end(reports, cfg, mix, t_start):
    steps = reports[0]["steps"]
    window = max(r["window_s"] for r in reports)
    tokens_per_s = steps * reports[0]["tokens_per_step"] / window
    peak = peaks.of(reports[0]["kind"])["bf16_flops"]
    slowest = [max(r["step_ms"][k] for r in reports) for k in range(steps)]
    return {
        "tokens_per_s": tokens_per_s,
        "mfu_pct": 100.0 * tokens_per_s
        * arith.flops_per_token(cfg, mix["seq"]) / peak,
        "step_ms_p90": arith.percentile(slowest, 90),
        "setup_s": max(r["window_start"] for r in reports) - t_start,
    }


def _combine(bench, reports):
    """Per-layer values over the ranks: each metric's ``COMBINE`` (the
    largest, or by default the mean) of the ranks that read it."""
    out = {}
    for name in reports[0]["layer"]:
        vals = [r["layer"][name] for r in reports if name in r["layer"]]
        how = getattr(bench.metric(name), "COMBINE", "mean")
        out[name] = max(vals) if how == "max" else sum(vals) / len(vals)
    return out


def _breakdown(reports):
    ops = {}
    for r in reports:
        for name, sec in r["device_ops"]:
            ops[name] = ops.get(name, 0.0) + sec / len(reports)
    gaps = sorted((g for r in reports for g in r["idle_gaps"]),
                  key=lambda g: -g[1])
    return {"device_ops": [[k, v] for k, v in
                           sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": gaps[:10]}


def _in_diag_dir(fn, *args):
    """``fn(*args)`` with the program's diagnostics (``HOROVOD_DIAG_DIR``)
    in a fresh directory under ``TMPDIR``, removed after."""
    diag = tempfile.mkdtemp(prefix="bench-diag-")
    os.environ["HOROVOD_DIAG_DIR"] = diag
    try:
        return fn(*args)
    finally:
        shutil.rmtree(diag, ignore_errors=True)


def _num(x):
    """``x``, or its name where it is not finite (JSON has no
    infinity)."""
    return x if math.isfinite(x) else repr(x)


def main(argv=None):
    args = parse(argv)
    t_start = args.t_start if args.t_start is not None else process_start()
    os.environ.setdefault("HOROVOD_PROFILER_DISABLE", "1")
    build = Path(args.root) / "build" / "benchmark"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ.setdefault(var, str(build / sub))
    bench = spec.Bench(args.root)
    cell = bench.cell(args.workload)
    world = cell["chips"]
    if args.worker:
        if args.seeds:
            report = {"readings": _in_diag_dir(
                readings, bench, args.workload,
                [int(x) for x in args.seeds.split(",")], args.rank,
                args.device)}
        else:
            report = _in_diag_dir(drive, bench, args.workload, args.seed,
                                  args.seconds, args.trace, args.rank, world,
                                  args.device, t_start)
        report["forbidden"] = imports.loaded()
        print(RESULT_TAG + json.dumps(report), flush=True)
        return 0
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if args.device == "cuda" and found < world:
        _say(f"no result: {args.workload} needs {world} CUDA device(s), "
             f"found {found}")
        return 2
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    limits = bench.limits(args.workload)
    if world == 1:
        reports = [_in_diag_dir(drive, bench, args.workload, args.seed,
                                args.seconds, args.trace, 0, 1, args.device,
                                t_start)]
    else:
        reports = spawn(args, world, t_start)
        if reports is None:
            return 1

    t_ref = time.perf_counter()
    ref_devs = ([torch.device("cuda", i) for i in range(world)]
                if args.device == "cuda" else ["cpu"])
    ref = reference_readings(bench, cfg, mix, args.seed, world, ref_devs[0],
                             ref_devs)
    t_ref = time.perf_counter() - t_ref
    program = {k: [r["readings"][k] for r in reports]
               for k in READINGS}
    values = judge.checks(program, ref)
    ok, shown = judge.verdict(values, limits)
    failed = max(r["failed"] for r in reports)
    correct = ok and failed == 0
    # once the window has closed: this process's modules and the workers'
    forbidden = sorted(set(imports.loaded()).union(
        *(r.get("forbidden", ()) for r in reports)))
    if forbidden:
        _say("no result: JAX modules were loaded: " + ", ".join(forbidden))
        return 3

    e2e = _end_to_end(reports, cfg, mix, t_start)
    kind = reports[0]["kind"]
    if args.trace:
        values_out = _combine(bench, reports)
        names = bench.per_layer(args.workload)
    else:
        values_out = e2e
        names = bench.end_to_end(args.workload)
    metrics = {m["name"]: {"value": values_out[m["name"]], "unit": m["unit"]}
               for m in names if m["name"] in values_out}
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": kind, "count": world,
              "memory_peak_bytes": max(r["peak_bytes"] for r in reports)}
    if args.trace:
        device["busy_s"] = sum(r["busy_s"] for r in reports) / world
        device["window_s"] = sum(r["trace_window_s"] for r in reports) / world
    steps = reports[0]["steps"]
    print(f"# cell {args.workload}, seed {args.seed}, {world} x {kind}")
    print(f"# window: {steps} steps in {max(r['window_s'] for r in reports)} s"
          f" (asked {args.seconds} s); set-up {e2e['setup_s']} s; "
          f"reference {t_ref} s")
    print("# step_ms (slowest rank, " + str(steps) + " samples): "
          + json.dumps([max(r["step_ms"][k] for r in reports)
                        for k in range(steps)]))
    print("# end to end: " + json.dumps(e2e))
    print("# program losses: " + json.dumps(program["losses"])
          + "; reference: " + json.dumps(ref["losses"]))
    if args.trace:
        print("# device seconds by kernel, rank 0's traced window: "
              + json.dumps(reports[0]["kernels"]))
    for name, (value, leaf) in values.items():
        print(f"# {name} {value} (worst leaf {leaf}), limit "
              f"{limits.get(name, 'none: shown, not compared')}")
    for name, v in shown.items():
        _say(f"check {name} {v['value']} limit {v['limit']}")
    _say(f"check failed_steps {failed} limit 0")
    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = _breakdown(reports)
    result["checks"] = dict(
        {k: {"value": _num(v["value"]), "limit": v["limit"]}
         for k, v in shown.items()},
        failed_steps={"value": failed, "limit": 0})
    print(json.dumps(result), flush=True)
    return 0
