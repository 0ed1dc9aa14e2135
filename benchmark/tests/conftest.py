"""The benchmark's own tests: ``pytest benchmark/tests`` from the root of
the checkout. They run on the CPU at tiny sizes; a test that needs the
card is marked ``cuda`` and decides inside itself whether there is
one."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: The tiny sizes a CPU run can hold: every width cut, nothing else
#: changed from the cell's configuration.
TINY = dict(vocab_size=512, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=512, max_seq=64, loss_chunk=32)
TINY_MIX = dict(batches=4, batch=2, seq=64)
#: tiny cell -> (the real cell whose configuration, traffic and limits
#: it shrinks, entry or None for the traffic's own)
TINY_CELLS = {
    "tiny-train": ("flagship-train-4k", None),
    "tiny-moe-train": ("flagship-moe-train-4k", None),
    "tiny-dp": ("flagship-dp4-train-4k", None),
}


def make_tiny_root(tmp, cells=TINY_CELLS, moe_experts=4):
    """A checkout holding a copy of the benchmark folder and a
    ``BENCHMARK.json`` of tiny cells, each the shrunken copy of a real
    cell, held to the real cell's limits; returns its root."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        doc = json.load(f)
    real = {w["name"]: w for w in doc["workloads"]}
    configs, workloads = {}, []
    for name, (base, entry) in cells.items():
        w = real[base]
        cfg_name = f"tiny-{w['config']}"
        if cfg_name not in configs:
            src = next(c for c in doc["configs"] if c["name"] == w["config"])
            with open(ROOT / src["file"], encoding="utf-8") as f:
                cfg = json.load(f)
            cfg.update(TINY, name=cfg_name)
            if cfg["moe_layers"]:
                cfg.update(moe_layers=[1], moe_num_experts=moe_experts)
            path = f"benchmark/configs/{cfg_name}.json"
            with open(root / path, "w", encoding="utf-8") as f:
                json.dump(cfg, f)
            configs[cfg_name] = dict(src, name=cfg_name, file=path)
        with open(BENCH / "traffic" / f"{w['traffic']}.json",
                  encoding="utf-8") as f:
            mix = json.load(f)
        mix.update(TINY_MIX)
        if entry:
            mix["entry"] = entry
        with open(root / "benchmark" / "traffic" / f"{name}.json", "w",
                  encoding="utf-8") as f:
            json.dump(mix, f)
        shutil.copy(BENCH / "limits" / f"{base}.json",
                    root / "benchmark" / "limits" / f"{name}.json")
        workloads.append(dict(w, name=name, config=cfg_name, traffic=name))
    renamed = {real_name: [n for n, (b, _) in cells.items() if b == real_name]
               for real_name in real}
    for m in doc["per_layer"]:
        m["workloads"] = [n for w in m.get("workloads", real)
                          for n in renamed.get(w, [])]
    doc["per_layer"] = [m for m in doc["per_layer"] if m["workloads"]]
    doc.update(configs=list(configs.values()), workloads=workloads)
    with open(root / "BENCHMARK.json", "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture(autouse=True)
def _environment():
    """A run sets the program's variables for itself; each test starts
    from the environment as it was. Several gloo ranks share a few
    cores: one thread each."""
    saved = dict(os.environ)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    os.environ.clear()
    os.environ.update(saved)


def run_cell(root, cell, seed=11, seconds=0.5, trace=0, capsys=None,
             device="cpu"):
    """One run of ``cell`` under ``root`` on ``device``, in this process
    (its workers in their own); ``(exit code, result dict or None)``."""
    from yardstick import cell as cell_mod
    code = cell_mod.main(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace),
                          "--root", str(root), "--device", device])
    out = capsys.readouterr().out if capsys else ""
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return code, (json.loads(lines[-1]) if lines else None)


def card_present():
    import torch
    return torch.cuda.is_available()


os.environ.setdefault("USE_FLAX", "0")
