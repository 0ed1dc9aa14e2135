"""The port's benches (horovod_tpu_torch/bench) and its peak-FLOPs table
(horovod_tpu_torch/hardware.py) on the CPU.

Both bench modules run end to end with ``--device cpu`` at tiny sizes
(the ResNet one in its ``HOROVOD_BENCH_SMOKE=1`` shrink) and must print
one JSON line with the reference's keys: the metric name, a positive
value, ``mfu_pct`` null (the CPU has no peak, and no rate from a CPU is
put under a device metric), and every profile whose subsystem is not
ported as ``{"skipped": "not ported: ROADMAP item N"}``. Beside them:
the FLOPs-per-token model and the robust statistics against the
reference scripts' own functions, the refusals of the unported
scenarios, and the H100 rows of the peak table.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from horovod_tpu_torch import config as config_mod
from horovod_tpu_torch import hardware
from horovod_tpu_torch.bench import resnet as resnet_bench
from horovod_tpu_torch.bench import transformer as tfm_bench
from horovod_tpu_torch.models import transformer as tfm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402  the reference scripts, for their functions
import bench_transformer  # noqa: E402

TINY = ["--d-model", "32", "--layers", "1", "--heads", "2", "--kv-heads",
        "0", "--vocab", "128", "--seq-len", "64", "--batch-per-chip", "2",
        "--loss-chunk", "32"]


def _run(module, args, **env):
    out = subprocess.run(
        [sys.executable, "-m", module, *args], cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "2", **env},
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout[-2000:]
    return json.loads(lines[0])


def test_resnet_bench_smoke_json_contract():
    got = _run("horovod_tpu_torch.bench.resnet", ["--device", "cpu"],
               HOROVOD_BENCH_SMOKE="1")
    assert got["metric"] == "resnet50_img_sec_per_chip"
    assert got["unit"] == "img/sec"
    assert got["value"] > 0 and got["img_sec_block_timed"] > 0
    assert got["vs_baseline"] == round(got["value"] / 103.55, 3)
    assert got["batch_per_chip"] == 8
    assert set(got["sweep"]) == {"8"} and got["sweep"]["8"] > 0
    assert got["samples"] == 2 and got["outliers_rejected"] >= 0
    assert isinstance(got["ci_degraded"], bool) and got["ci_pct"] >= 0
    assert got["mfu_pct"] is None
    assert got["card"] is None
    assert "CUDA card" in got["transformer"]["skipped"]
    for key, item in resnet_bench.NOT_PORTED.items():
        assert got[key] == {"skipped": f"not ported: ROADMAP item {item}"}
    assert set(resnet_bench.NOT_PORTED) >= {
        "eager_exchange", "compiled_step", "zero_profile", "serve", "moe",
        "mesh3d", "control_plane"}


def test_transformer_bench_json_contract():
    got = _run("horovod_tpu_torch.bench.transformer",
               [*TINY, "--iters", "1", "--device", "cpu"])
    assert got["metric"] == "transformer_tokens_per_sec_per_chip"
    assert got["unit"] == "tokens/sec"
    assert got["value"] > 0
    assert got["mfu_pct"] is None
    assert got["tokens_per_sec_device_side"] is None
    assert got["card"] is None
    assert got["attention"] == "flash"
    assert (got["batch_per_chip"], got["seq_len"], got["d_model"],
            got["layers"]) == (2, 64, 32, 1)
    assert got["flops_per_token"] > 0


@pytest.mark.parametrize("flag,item", [("--moe", 7), ("--mesh3d", 6),
                                       ("--serve", 9)])
def test_unported_scenarios_raise_naming_their_item(flag, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tfm_bench.parse_args([flag])


@pytest.mark.parametrize("argv", [[], TINY])
def test_flops_per_token_matches_the_reference(argv):
    """The port's FLOPs model on the port's parameters against
    bench_transformer.py's on the reference's (shapes from
    ``jax.eval_shape``, no compile), for the flagship and a tiny model."""
    ref_args = bench_transformer.parse_args(argv)
    ref_cfg = bench_transformer.build_cfg(ref_args)
    ref_params = jax.eval_shape(lambda: bench_transformer.tfm.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    want = bench_transformer.flops_per_token(ref_params, ref_cfg)
    cfg = tfm_bench.build_cfg(tfm_bench.parse_args(argv))
    shapes = tfm.param_shapes(cfg)
    params = {k: torch.empty(s, device="meta") for k, s in shapes.items()
              if k != "layers"}
    params["layers"] = [{k: torch.empty(s, device="meta")
                         for k, s in layer.items()}
                        for layer in shapes["layers"]]
    assert tfm_bench.flops_per_token(params, cfg) == want


def test_robust_stats_match_the_reference():
    rng = np.random.default_rng(0)
    samples = list(rng.normal(100.0, 2.0, 20)) + [40.0]
    assert resnet_bench._robust_stats(samples) == \
        bench._robust_stats(samples)
    assert resnet_bench._robust_stats([5.0, 5.0])[3] == 0


def test_smoke_protocol_is_the_reference_shrink(monkeypatch):
    monkeypatch.setenv("HOROVOD_BENCH_SMOKE", "1")
    smoke = resnet_bench.Protocol.from_env()
    assert (smoke.batch_candidates, smoke.num_iters, smoke.sweep_iters,
            smoke.batches_per_iter, smoke.image_size) == (
        (8,), 2, 1, 2, 64)
    monkeypatch.setenv("HOROVOD_BENCH_SMOKE", "0")
    full = resnet_bench.Protocol.from_env()
    assert full.batch_candidates == bench.BATCH_CANDIDATES == \
        (32, 64, 128, 256, 512)
    assert (full.num_iters, full.batches_per_iter, full.image_size) == (
        10, 10, 224)
    assert resnet_bench.ANALYTIC_TRAIN_FLOPS_PER_IMAGE == \
        bench.ANALYTIC_TRAIN_FLOPS_PER_IMAGE
    assert resnet_bench.BASELINE_IMG_SEC_PER_DEVICE == \
        bench.BASELINE_IMG_SEC_PER_DEVICE


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                       ("NVIDIA H100 PCIe", 756e12),
                                       ("NVIDIA A100-SXM4-80GB", 0.0),
                                       ("", 0.0), (None, 0.0)])
def test_peak_table_resolves_the_h100_names(name, peak):
    assert hardware.peak_flops_for_kind(name) == peak


def test_peak_flops_per_chip_reads_the_knob_and_knows_no_cpu(monkeypatch):
    assert hardware.peak_flops_per_chip(None, torch.device("cpu")) == 0.0
    monkeypatch.setenv("HOROVOD_PEAK_FLOPS", "1.5e14")
    cfg = config_mod.Config.from_env()
    assert cfg.peak_flops == 1.5e14
    assert hardware.peak_flops_per_chip(cfg, torch.device("cpu")) == 1.5e14
