"""The readings a cell's correctness limits are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--witness-seeds ...] [--control-seeds ...] [--fault-seeds ...] \\
        --out readings.jsonl

For each of ``--seeds`` it drives the program through the cell's first
steps, as a run's set-up does, and compares those readings with the
plain reference's (``program``: the lower reading of each number). On
the other seeds it puts the reference itself in the program's place:

- ``witness``: products on bfloat16 operands, the precision the
  configuration states (a program that computes at that precision reads
  about this);
- ``control``: products on float8 e4m3 operands, the precision below it
  (the upper reading: the check must fail it);
- ``fault-half``: half of each batch left out, the mean over the rest;
- ``fault-stale``: every step on the first step's batch (a replay whose
  inputs are never copied into the graph's own);
- ``fault-noexchange`` (several ranks): each rank steps on its own
  gradient, the exchange between cards left out.

A cell on several cards reads the program on them (``--program-only``
writes those readings), and the reference on one card
(``--program-from`` reads them back), so the references hold one card
only. Each reading is a JSON line; a summary goes to standard error.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

from yardstick import cell, judge, spec  # noqa: E402


def _seeds(text):
    return [int(x) for x in text.split(",")] if text else []


def _compare(bench, cfg, mix, world, dev, program, sides, kwargs, out,
             summary):
    """For each seed: the reference, then each side put in the program's
    place (the program's own readings for ``program``), compared; a JSON
    line each to ``out``, the numbers into ``summary`` by side."""
    for s in sorted({s for v in sides.values() for s in v}):
        t0 = time.perf_counter()
        ref = cell.reference_readings(bench, cfg, mix, s, world, dev)
        for kind, chosen in sides.items():
            if s not in chosen:
                continue
            got = program[s] if kind == "program" else cell.follow(
                bench, cfg, mix, s, world, dev, **kwargs[kind])
            values = judge.checks(got, ref)
            line = {"seed": s, "kind": kind,
                    "values": {k: v[0] for k, v in values.items()},
                    "leaves": {k: v[1] for k, v in values.items()},
                    "seconds": time.perf_counter() - t0,
                    "readings": got, "reference": ref}
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps({k: line[k] for k in
                              ("seed", "kind", "values", "leaves")}),
                  file=sys.stderr, flush=True)
            summary.setdefault(kind, []).append(line["values"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--program-from", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    bench = spec.Bench(args.root)
    c = bench.cell(args.workload)
    cfg, mix = bench.config(c["config"]), bench.traffic(c["traffic"])
    world = c["chips"]
    seeds = _seeds(args.seeds)
    os.environ.setdefault("HOROVOD_PROFILER_DISABLE", "1")

    if args.program_from:
        with open(args.program_from, encoding="utf-8") as f:
            program = {r["seed"]: r["readings"] for r in map(json.loads, f)}
        seeds = seeds or sorted(program)
    elif world == 1:
        program = {r["seed"]: {k: [v] for k, v in r["readings"].items()}
                   for r in cell.readings(bench, args.workload, seeds, 0,
                                          args.device)}
    else:
        run_args = argparse.Namespace(
            workload=args.workload, seed=0, seconds=0.0, trace=0,
            root=args.root, device=args.device)
        reports = cell.spawn(run_args, world, time.time(),
                             ["--seeds", ",".join(map(str, seeds))])
        if reports is None:
            return 1
        program = {s: {k: [r["readings"][i]["readings"][k] for r in reports]
                       for k in cell.READINGS}
                   for i, s in enumerate(seeds)}
    if args.program_only:
        with open(args.out, "a", encoding="utf-8") as out:
            for s in seeds:
                out.write(json.dumps({"seed": s, "readings": program[s]})
                          + "\n")
        return 0

    dev = torch.device("cuda", 0) if args.device == "cuda" else "cpu"
    sides = {"program": seeds,
             "witness": _seeds(args.witness_seeds),
             "control": _seeds(args.control_seeds),
             "fault-half": _seeds(args.fault_seeds),
             "fault-stale": _seeds(args.fault_seeds)}
    if world > 1:
        sides["fault-noexchange"] = _seeds(args.fault_seeds)
    kwargs = {"witness": {"fmt": "bf16"}, "control": {"fmt": "fp8"},
              "fault-half": {"rows": mix["batch"] // 2},
              "fault-stale": {"stale": True},
              "fault-noexchange": {"average": False}}
    summary = {}
    with open(args.out, "a", encoding="utf-8") as out:
        _compare(bench, cfg, mix, world, dev, program, sides, kwargs, out,
                 summary)
    for kind, rows in summary.items():
        lo = {k: min(r[k] for r in rows) for k in judge.NAMES}
        hi = {k: max(r[k] for r in rows) for k in judge.NAMES}
        print(f"# {kind} over {len(rows)} seeds: least {lo}, most {hi}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
