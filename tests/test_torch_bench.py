"""The port's benches (horovod_tpu_torch/bench) and its peak-FLOPs table
(horovod_tpu_torch/hardware.py) on the CPU.

Both bench modules run end to end with ``--device cpu`` at tiny sizes
(the ResNet one in its ``HOROVOD_BENCH_SMOKE=1`` shrink) and must print
one JSON line with the reference's keys: the metric name, a positive
value, ``mfu_pct`` null (the CPU has no peak, and no rate from a CPU is
put under a device metric), the compiled-step and serving rows with
their counters, and every profile whose subsystem is not ported as
``{"skipped": "not ported: ROADMAP item N"}``. Beside them:
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


# The bench rounds vs_baseline from the unrounded mean,
# round(mean / 103.55, 3), and value is round(mean, 2): from value the
# contract is only known to the two roundings' half units, 0.0005 and
# 0.005 / 103.55 (asserting round(value / 103.55, 3) failed for about
# 2.4% of rates, e.g. a mean of 22.6257 img/s: value 22.63, vs_baseline
# 0.218, round(22.63 / 103.55, 3) = 0.219).
VS_BASELINE_BOUND = 0.0005 + 0.005 / 103.55


def test_resnet_bench_smoke_json_contract():
    got = _run("horovod_tpu_torch.bench.resnet", ["--device", "cpu"],
               HOROVOD_BENCH_SMOKE="1")
    assert got["metric"] == "resnet50_img_sec_per_chip"
    assert got["unit"] == "img/sec"
    assert got["value"] > 0 and got["img_sec_block_timed"] > 0
    assert abs(got["vs_baseline"] - got["value"] / 103.55) \
        <= VS_BASELINE_BOUND
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
        "eager_exchange", "zero_profile", "moe", "mesh3d", "control_plane"}
    assert not set(resnet_bench.NOT_PORTED) & {"compiled_step", "serve"}
    compiled = got["compiled_step"]
    assert compiled["img_sec_per_chip"] > 0
    assert compiled["python_overhead_ms"] > 0
    assert compiled["mfu_pct"] is None
    # the untimed calls built the one program; the timed steps all hit
    assert compiled["step_program_cache_misses"] == 0
    assert compiled["step_program_cache_hits"] == compiled["steps"] + 2
    assert compiled["step_program_cache_hit_rate"] == 1.0
    assert compiled["compiled_steps"] == compiled["steps"] + 4
    assert compiled["fallback_steps"] == 0
    assert compiled["samples"] == compiled["steps"] == 12
    for key, item in resnet_bench.COMPILED_NOT_PORTED.items():
        assert compiled[key] == {
            "skipped": f"not ported: ROADMAP item {item}"}
    assert {"overlap_ab", "step_phase_breakdown"} <= set(
        resnet_bench.COMPILED_NOT_PORTED)
    _assert_serve_row(got["serve"], streams=8, prompt_len=16, new_tokens=32)


def _assert_serve_row(serve, streams, prompt_len, new_tokens):
    """bench_transformer.py's serve sub-dict: one prefill and one decode
    program for the run (bin floors pinned), so the steady state hits."""
    assert serve["tokens_per_sec"] > 0
    assert (serve["streams"], serve["prompt_len"], serve["new_tokens"]) == (
        streams, prompt_len, new_tokens)
    for key in ("ttft_p50_ms", "ttft_p99_ms", "token_latency_p50_ms",
                "token_latency_p99_ms"):
        assert serve[key] > 0, key
    assert serve["ttft_p50_ms"] <= serve["ttft_p99_ms"]
    assert serve["decode_cache_hit_rate"] >= 0.9
    assert serve["steady_state_decode_hit_rate"] == 1.0
    assert (serve["prefill_cache_misses"], serve["decode_cache_misses"]) == (
        1, 1)
    assert serve["fallback_steps"] == 0
    assert serve["devices"] == 1 and serve["card"] is None


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


def test_transformer_serve_json_contract():
    got = _run("horovod_tpu_torch.bench.transformer",
               ["--serve", "--serve-streams", "4", "--serve-prompt-len", "8",
                "--serve-new-tokens", "6", "--serve-d-model", "32",
                "--serve-heads", "4", "--serve-vocab", "128", "--device",
                "cpu"])
    assert got["metric"] == "serve_tokens_per_sec"
    assert got["unit"] == "tokens/sec"
    assert got["value"] == got["serve"]["tokens_per_sec"] > 0
    _assert_serve_row(got["serve"], streams=4, prompt_len=8, new_tokens=6)
    assert (got["serve"]["d_model"], got["serve"]["heads"],
            got["serve"]["vocab"], got["serve"]["layers"]) == (32, 4, 128, 2)


def test_serve_over_several_ranks_raises_naming_item_6(monkeypatch):
    monkeypatch.setattr(tfm_bench.runtime, "size", lambda: 2)
    try:
        with pytest.raises(NotImplementedError, match="item 6"):
            tfm_bench.run_serve_benchmark(
                tfm_bench.parse_args(["--serve", "--device", "cpu"]))
    finally:
        tfm_bench.runtime.shutdown()


def test_serve_defaults_are_the_reference_flags():
    ref = vars(bench_transformer.parse_args(["--serve"]))
    got = vars(tfm_bench.parse_args(["--serve"]))
    keys = [k for k in ref if k.startswith("serve")]
    assert len(keys) == 9
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}


@pytest.mark.parametrize("flag,item", [("--moe", 7), ("--mesh3d", 6)])
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
