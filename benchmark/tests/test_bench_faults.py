"""A run with the timed path broken underneath comes out not correct:
each fault a training cell can have, through the rest of a real run
(set-up, window, reference, verdict) on the CPU, at tiny sizes, held to
the real cells' limits. The same runs unbroken come out correct. On a
card, a fault in the replays alone, at the MoE cell's own size."""

import json
import shutil

import pytest

from conftest import BENCH, ROOT, card_present, make_tiny_root, run_cell

BROKEN = BENCH / "tests" / "broken"
CELLS = {
    "tiny-train": ("flagship-train-4k", None),
    "tiny-frozen": ("flagship-train-4k", "frozen_step"),
    "tiny-half": ("flagship-train-4k", "half_batch"),
    "tiny-altered": ("flagship-train-4k", "altered_loss"),
    "tiny-stale": ("flagship-train-4k", "stale_inputs"),
    "tiny-moe-train": ("flagship-moe-train-4k", None),
    "tiny-moe-frozen": ("flagship-moe-train-4k", "frozen_step"),
    "tiny-moe-half": ("flagship-moe-train-4k", "half_batch"),
    "tiny-moe-stale": ("flagship-moe-train-4k", "stale_inputs"),
    "tiny-dp": ("flagship-dp4-train-4k", None),
    "tiny-dp-alone": ("flagship-dp4-train-4k", "no_exchange"),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("faults"), cells=CELLS)
    for path in BROKEN.glob("*.py"):
        shutil.copy(path, root / "benchmark" / "entries" / path.name)
    return root


@pytest.mark.parametrize("cell, correct", [
    ("tiny-train", True), ("tiny-frozen", False), ("tiny-half", False),
    ("tiny-altered", False), ("tiny-stale", False), ("tiny-moe-train", True),
    ("tiny-moe-frozen", False), ("tiny-moe-half", False),
    ("tiny-moe-stale", False),
    ("tiny-dp", True), ("tiny-dp-alone", False)])
def test_a_broken_step_is_not_correct(root, cell, correct, capsys):
    code, result = run_cell(root, cell, seed=2147483999, capsys=capsys)
    assert code == 0 and result is not None
    assert result["correct"] is correct, result["checks"]


@pytest.mark.cuda
def test_a_replay_on_stale_inputs_is_not_correct_at_the_cells_size(
        tmp_path, capsys):
    """The MoE cell at its own size, its graph replayed on the first
    step's inputs: the eager first step is sound, the replays are not."""
    if not card_present():
        pytest.skip("needs an NVIDIA card: the cell's own size")
    name, base = "moe-stale", "flagship-moe-train-4k"
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = tmp_path / "benchmark"
    shutil.copy(BROKEN / "stale_inputs.py", bench / "entries")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in doc["workloads"] if w["name"] == base)
    mix = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    (bench / "traffic" / f"{name}.json").write_text(
        json.dumps(dict(mix, entry="stale_inputs")))
    shutil.copy(bench / "limits" / f"{base}.json",
                bench / "limits" / f"{name}.json")
    doc["workloads"].append(dict(w, name=name, traffic=name))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    code, result = run_cell(tmp_path, name, seed=2147483801, seconds=2,
                            capsys=capsys, device="cuda")
    assert code == 0 and result is not None
    print(json.dumps(result["checks"]))
    assert result["correct"] is False, result["checks"]
