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
reference scripts' own functions, the MoE scenario's row and flags,
the refusals of the unported scenarios, and the H100 rows of the peak
table.
"""

import functools
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


@functools.lru_cache(maxsize=None)
def _resnet_smoke():
    """The ResNet bench's line in its smoke shrink, run once a module."""
    return _run("horovod_tpu_torch.bench.resnet", ["--device", "cpu"],
                HOROVOD_BENCH_SMOKE="1")


def test_resnet_bench_smoke_json_contract():
    got = _resnet_smoke()
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
    # every profile is filled, the control plane's simulated ranks too
    assert not resnet_bench.NOT_PORTED
    ctrl = got["control_plane"]
    assert ctrl["worlds"] == [8] and ctrl["fanout"] == 4
    for cell in ctrl["cells"]:
        for mode in ("star", "tree", "graduated"):
            assert cell[mode]["coordinator_rounds_per_sec"] > 0
            assert cell[mode]["decision_streams_identical"]
    assert ctrl["acceptance"]["graduated_o1_reads_ok"]
    assert ctrl["acceptance"]["decisions_bit_identical"]
    assert ctrl["acceptance"]["demotion_on_membership_change"]
    assert not set(resnet_bench.NOT_PORTED) & {"dispatch", "eager_exchange"}
    assert not set(resnet_bench.NOT_PORTED) & {
        "compiled_step", "serve", "moe", "zero_profile", "mesh3d",
        "flight_step_phase_breakdown", "flight_overhead_frac",
        "trace_overhead_frac", "step_phase_breakdown"}
    # the eager loop's flight attribution (the CPU's loop has no wire
    # time of its own worth a phase: compute carries the call)
    flight = got["flight_step_phase_breakdown"]
    assert set(flight) == {"compute_ms", "wire_ms", "readback_ms",
                           "input_ms"}
    assert flight["compute_ms"] > 0 and flight["wire_ms"] >= 0
    assert 0 <= got["flight_overhead_frac"] < 0.01
    assert 0 <= got["trace_overhead_frac"] < 0.01
    assert got["step_phase_breakdown"] == \
        got["compiled_step"]["step_phase_breakdown"]
    # bench.py's mesh3d row needs 8 ranks: at one, its reason
    assert got["mesh3d"] == {
        "skipped": "needs a device count divisible by 8 and the "
                   "device-resident path for the 2x2x2 (data, expert, "
                   "model) mesh"}
    _assert_moe_row(got["moe"], expert_parallel=1, steps=8)
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
    # the guard is ported (item 15): its row is measured, on both loops
    assert not resnet_bench.COMPILED_NOT_PORTED
    assert 0 <= compiled["guard_overhead_frac"] < 0.02
    assert 0 <= got["guard_overhead_frac"] < 0.02
    # the input pipeline (item 14): prefetch hides the production cost
    pipe = got["input_pipeline"]
    assert pipe["prefetch"]["prefetch_depth"] == resnet_bench.DATA_PREFETCH
    assert pipe["sync"]["prefetch_depth"] == 0
    assert pipe["sync"]["data_wait_ms"] > pipe["prefetch"]["data_wait_ms"]
    assert pipe["sync"]["batches"] == pipe["prefetch"]["batches"] == 6
    # the phase trace of 4 steps: the step's regions, the tiers (no
    # staged exchange at one rank) and the overlap rows
    phases = compiled["step_phase_breakdown"]
    for phase in ("forward", "backward", "exchange", "optimizer"):
        assert phases[phase] > 0, phase
    assert compiled["wire_stage_ms"] == {"ici": 0.0, "dcn": 0.0}
    assert "xla-trace-" in compiled["xla_trace_dir"]
    assert 0.0 <= compiled["exchange_hidden_frac"] <= 1.0
    assert compiled["exchange_buckets"] == resnet_bench.EXCHANGE_BUCKETS
    ab = compiled["overlap_ab"]
    assert (ab["buckets_base"], ab["buckets_tuned"]) == (
        1, resnet_bench.EXCHANGE_BUCKETS)
    assert ab["step_ms_base"] > 0 and ab["step_ms_tuned"] > 0
    assert ab["hidden_frac_tuned"] == compiled["exchange_hidden_frac"]
    micro = compiled["overlap_microbench"]
    assert (micro["depth"], micro["width"]) == (8, 256)
    for side in ("base", "tuned"):
        assert micro[f"step_ms_{side}"] > 0
        assert micro[f"exchange_ms_{side}"] > 0
        assert 0.0 <= micro[f"hidden_frac_{side}"] <= 1.0
    assert 0 <= compiled["trace_overhead_frac"] < 0.01
    # no skipped row names a finished item (11: the ZeRO ladder; 6:
    # tensor parallelism)
    assert not {6, 11} & (set(resnet_bench.NOT_PORTED.values()) | set(
        resnet_bench.COMPILED_NOT_PORTED.values()))
    _assert_serve_row(got["serve"], streams=8, prompt_len=16, new_tokens=32)


def test_resnet_bench_fills_the_eager_engine_rows():
    """bench.py's ``dispatch`` and ``eager_exchange`` profiles, through
    the port's eager engine on the CPU: every key, the wire-layout cache
    warm after the first step, the results on the device."""
    got = _resnet_smoke()
    d = got["dispatch"]
    assert set(d) == {"enqueue_ms", "readback_ms", "readback_sync_ms",
                      "full_ms", "overlap_efficiency"}
    assert all(v >= 0 for v in d.values())
    assert 0.0 <= d["overlap_efficiency"] <= 1.0
    x = got["eager_exchange"]
    assert set(x) == {"wire_cache_hit_rate", "wire_cache_hits",
                      "wire_cache_misses", "eager_sync_wait_ms",
                      "device_resident_results", "steps"}
    assert x["steps"] == 12  # the smoke shrink
    assert x["wire_cache_misses"] == 1  # one bucket signature, once
    assert x["wire_cache_hit_rate"] >= 0.9
    assert x["device_resident_results"] is True
    assert x["eager_sync_wait_ms"] >= 0


def test_eager_bench_json_contract():
    """bench/eager.py's line on the CPU, under bench_eager.py's metric."""
    got = _run("horovod_tpu_torch.bench.eager",
               ["--device", "cpu", "--tensors", "16", "--repeats", "1"])
    assert got["metric"] == "eager_allreduce_mbytes_sec"
    assert got["unit"] == "MB/s" and got["value"] > 0
    assert set(got["configs"]) == {"fused_cached", "fused_nocache",
                                   "unfused_cached", "unfused_nocache",
                                   "broadcast"}
    assert all(v > 0 for v in got["configs"].values())
    assert got["vs_baseline"] == pytest.approx(
        got["configs"]["fused_cached"] / got["configs"]["unfused_nocache"])
    assert got["card"] is None and got["device"] == "cpu"


def test_resnet_bench_fills_the_zero_profile_row():
    """bench.py's ``zero_profile`` at one rank on the CPU: its keys, the
    two losses finite and equal (one rank has no DCN stage: both runs are
    the same exchange), ``dcn_bytes_saved_frac`` None as the reference's
    formula gives at n 1, and the zero3 stripes' bytes from the real
    buffers (at n 1, the whole row: 256 x 256 + 256 + 256 x 8 + 8
    parameters; Adam's state twice that and its step count)."""
    zero = _resnet_smoke()["zero_profile"]
    assert "skipped" not in zero
    assert (zero["zero_stage"], zero["dcn_local_size"], zero["steps"]) == (
        2, 1, 8)
    assert zero["dcn_bytes_saved_frac"] is None
    assert np.isfinite(zero["loss_uncompressed"])
    assert zero["loss_compressed"] == zero["loss_uncompressed"]
    assert zero["dcn_loss_delta"] == 0.0
    mem = zero["zero_memory"]
    row = 4 * (256 * 256 + 256 + 256 * 8 + 8)
    assert mem["world_size"] == 1
    assert mem["params_full_bytes"] == mem["params_stripe_bytes"] == row
    assert mem["grads_stripe_bytes"] == row
    assert mem["opt_state_stripe_bytes"] == 2 * row + 4
    assert mem["resident_frac_of_replicated"] == 1.0


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


def test_serve_over_several_ranks_raises_naming_item_6():
    """``--serve`` over 2 ranks, which raised naming ROADMAP.md item 6
    until the item was ported: the model is tensor-parallel over both
    (the reference's serving on its mesh), each rank runs the engine in
    lockstep with rank 0, and both print the same tokens' row."""
    from torch_ranks import launch_ranks
    logs = launch_ranks(2, [
        "-m", "horovod_tpu_torch.bench.transformer", "--serve", "--device",
        "cpu", "--serve-streams", "2", "--serve-prompt-len", "4",
        "--serve-new-tokens", "4", "--serve-d-model", "32",
        "--serve-heads", "4", "--serve-vocab", "64"],
        env={"HOROVOD_PROFILER_DISABLE": "1"}, timeout=300)
    rows = [json.loads([ln for ln in log.splitlines()
                        if ln.startswith("{")][-1])["serve"]
            for log in logs]
    for row in rows:
        assert row["devices"] == 2 and row["fallback_steps"] == 0
        assert row["tokens_per_sec"] > 0
    assert rows[0]["scheduler_steps"] == rows[1]["scheduler_steps"]


def test_serve_defaults_are_the_reference_flags():
    ref = vars(bench_transformer.parse_args(["--serve"]))
    got = vars(tfm_bench.parse_args(["--serve"]))
    keys = [k for k in ref if k.startswith("serve")]
    assert len(keys) == 9
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}


def _assert_moe_row(moe, expert_parallel, steps):
    """bench_transformer.py's moe sub-dict: the layer trained through the
    compiled step (every timed step a cache hit), the routing counts of
    one evaluation, and the trace's keys: the phase breakdown of 4 traced
    steps, and no all-to-all time at one rank (None, as the reference's
    parser reads a capture without one)."""
    assert moe["tokens_per_sec_per_chip"] > 0
    assert moe["expert_parallel"] == expert_parallel
    assert moe["step_program_cache_hit_rate"] == 1.0
    assert (moe["step_program_cache_hits"], moe["step_program_cache_misses"],
            moe["fallback_steps"], moe["steps"]) == (steps, 0, 0, steps)
    # 32 sequences x 64 tokens x top-2, every one kept or dropped
    assert moe["routed_tokens"] + moe["dropped_tokens"] == 32 * 64 * 2
    assert moe["drop_fraction"] == round(
        moe["dropped_tokens"] / (32 * 64 * 2), 4)
    assert moe["load_balance_loss"] > 0
    assert (moe["num_experts"], moe["top_k"], moe["capacity_factor"],
            moe["d_model"], moe["d_ff"]) == (8, 2, 2.0, 256, 1024)
    assert expert_parallel == 1
    assert moe["alltoall_ms_per_step"] is None
    assert moe["alltoall_hidden_frac"] is None
    phases = moe["step_phase_breakdown"]
    # the expert FFN's forward under hvd_expert; no wire at one rank
    assert phases["expert"] > 0 and phases["backward"] > 0
    assert phases["dispatch"] == phases["combine"] == 0.0
    assert "xla-trace-" in moe["xla_trace_dir"]


def test_transformer_moe_json_contract():
    got = _run("horovod_tpu_torch.bench.transformer",
               ["--moe", "--expert-parallel", "1", "--iters", "1",
                "--moe-chunks", "4", "--device", "cpu"])
    assert got["metric"] == "moe_tokens_per_sec_per_chip"
    assert got["unit"] == "tokens/sec"
    assert got["value"] == got["moe"]["tokens_per_sec_per_chip"] > 0
    _assert_moe_row(got["moe"], expert_parallel=1, steps=8)
    # no expert group on one rank: the exchange is not cut
    assert got["moe"]["moe_chunks"] == 1


def test_moe_defaults_are_the_reference_flags():
    ref = vars(bench_transformer.parse_args(["--moe"]))
    got = vars(tfm_bench.parse_args(["--moe"]))
    keys = [k for k in ref if k.startswith(("moe", "expert"))]
    assert len(keys) == 9
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}


@pytest.mark.parametrize("flag,item", [("--mesh3d", 6)])
def test_unported_scenarios_raise_naming_their_item(flag, item,
                                                    monkeypatch):
    """``--mesh3d``, the scenario of ROADMAP.md item 6 (ported since):
    its flags and defaults are the reference's, and a world smaller than
    ep x mp ranks (one, here) raises the reference's error from
    ``init()``, leaving no process group behind."""
    assert item == 6
    ref = vars(bench_transformer.parse_args([flag]))
    got = vars(tfm_bench.parse_args([flag, "--device", "cpu"]))
    keys = [k for k in ref if k.startswith("mesh3d")]
    assert len(keys) == 8
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}
    # init() builds the expert mesh first, as the reference's does
    from horovod_tpu.parallel.mesh import expert_data_mesh
    with pytest.raises(ValueError) as want:
        expert_data_mesh(jax.devices()[:1], expert_parallel=2)
    # the bench re-inits with these set; monkeypatch restores them
    monkeypatch.setenv("HOROVOD_EXPERT_PARALLEL", "1")
    monkeypatch.setenv("HOROVOD_MODEL_PARALLEL", "1")
    try:
        with pytest.raises(ValueError) as err:
            tfm_bench.run_mesh3d_benchmark(tfm_bench.parse_args(
                [flag, "--device", "cpu"]))
        assert str(err.value) == str(want.value)
        assert not torch.distributed.is_initialized()
    finally:
        tfm_bench.runtime.shutdown()


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
