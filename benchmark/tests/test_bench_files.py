"""Cells, configurations, traffic mixes, entries and metrics are files
found by name: a later change adds them without editing a file that is
there. And ``BENCHMARK.json`` keeps the rules on names, units and
lines."""

import copy
import json
import shutil

import pytest

from conftest import ROOT, make_tiny_root, run_cell
from yardstick import judge, spec

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_benchmark_keeps_its_rules():
    assert spec.problems(DOC) == []
    bench = spec.Bench(ROOT)
    for w in DOC["workloads"]:
        cfg = bench.config(w["config"])
        mix = bench.traffic(w["traffic"])
        assert (bench.dir / "entries" / f"{mix['entry']}.py").exists()
        assert (bench.dir / "reference" / f"{cfg['reference']}.py").exists()
        limits = bench.limits(w["name"])
        assert limits and set(limits) <= set(judge.NAMES)
        assert bench.per_layer(w["name"]), w["name"]
        for m in bench.per_layer(w["name"]):
            assert callable(bench.metric(m["name"]).read)


@pytest.mark.parametrize("bad, what", [
    (lambda d: d["workloads"][0].update(name="has space"), "cell name"),
    (lambda d: d["end_to_end"][0].update(unit="tokens per second"), "unit"),
    (lambda d: d["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda d: d["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda d: d["workloads"][0].update(chips=2), "chips"),
    (lambda d: d["workloads"][1].update(name=d["workloads"][0]["name"]),
     "cell names repeat"),
    (lambda d: d["workloads"][0].update(why="two\nlines"), "why"),
    (lambda d: d["per_layer"][0].update(name="µs"), "metric name"),
    (lambda d: d.update(run_seconds=60), "run_seconds"),
    (lambda d: d["end_to_end"].pop(), "setup_s"),
])
def test_a_broken_rule_is_found(bad, what):
    doc = copy.deepcopy(DOC)
    bad(doc)
    assert any(what in p for p in spec.problems(doc))


def test_a_configuration_traffic_and_metric_added_as_files_are_found(
        tmp_path, capsys):
    root = make_tiny_root(tmp_path, cells={"tiny-train":
                                           ("flagship-train-4k", None)})
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    # new files only: a configuration, a traffic mix, a metric, a limit file
    cfg = json.loads((root / "benchmark/configs/tiny-flagship.json")
                     .read_text())
    cfg.update(name="wide", d_ff=768)
    (root / "benchmark/configs/wide.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/tiny-train.json").read_text())
    mix.update(batch=1, zipf_s=1.2)
    (root / "benchmark/traffic/short.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/loss_steps.py").write_text(
        "def read(ctx):\n    return ctx.steps * 1.0\n")
    shutil.copy(root / "benchmark/limits/tiny-train.json",
                root / "benchmark/limits/wide-short.json")
    # ... and new entries in BENCHMARK.json
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append(dict(doc["configs"][0], name="wide",
                               file="benchmark/configs/wide.json"))
    doc["workloads"].append({"name": "wide-short", "config": "wide",
                             "traffic": "short", "chips": 1, "why": "added"})
    doc["per_layer"].append({"name": "loss_steps", "unit": "count",
                             "better": "higher", "source": "program_counter",
                             "layer": "entry", "moves": "tokens_per_s",
                             "workloads": ["wide-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    assert spec.problems(doc) == []
    code, result = run_cell(root, "wide-short", trace=1, capsys=capsys)
    assert code == 0 and result["correct"], result
    assert result["metrics"]["loss_steps"]["value"] == 3.0
    # the metrics that list their cells do not list the new one
    assert set(result["metrics"]) == {"loss_steps"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_no_result_without_a_card(tmp_path, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from yardstick import cell
    code = cell.main(["--workload", "flagship-train-4k", "--seed", "1",
                      "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr().out
    assert code != 0 and not [ln for ln in out.splitlines()
                              if ln.startswith("{")]
