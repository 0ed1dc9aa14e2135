"""The control comes out not correct: the plain reference put in the
program's place with its products on float8 e4m3 operands, the
precision below the bfloat16 one the configurations state, held to each
cell's limits. Marked ``cuda``: at the cells' own sizes on the card (the
readings ``calibrate.py`` gives). On the CPU at tiny widths, the dense
cells' control fails their limits too; the MoE cell's does not reliably
there (at tiny widths the routing's flips read as much as the
precision), so its control is held at its own size only."""

import pytest
import torch

from conftest import ROOT, card_present, make_tiny_root
from yardstick import cell, judge, spec

SEEDS = (2147483701, 2147483702, 2147483703)


def control_verdicts(bench, name, device, seeds=SEEDS):
    c = bench.cell(name)
    cfg, mix = bench.config(c["config"]), bench.traffic(c["traffic"])
    out = []
    for seed in seeds:
        ref = cell.reference_readings(bench, cfg, mix, seed, c["chips"],
                                      device)
        got = cell.follow(bench, cfg, mix, seed, c["chips"], device,
                          fmt="fp8")
        out.append(judge.verdict(judge.checks(got, ref),
                                 bench.limits(name)))
    return out


@pytest.mark.parametrize("name", ["tiny-train", "tiny-dp"])
def test_the_control_fails_at_tiny_widths(tmp_path, name):
    bench = spec.Bench(make_tiny_root(tmp_path))
    for ok, shown in control_verdicts(bench, name, "cpu"):
        assert not ok, shown


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship-train-4k", "flagship-moe-train-4k",
                                  "flagship-dp4-train-4k"])
def test_the_control_fails_at_the_cells_sizes(name):
    if not card_present():
        pytest.skip("needs an NVIDIA card: the cell's own sizes")
    bench = spec.Bench(ROOT)
    for ok, shown in control_verdicts(bench, name, torch.device("cuda", 0)):
        assert not ok, shown
