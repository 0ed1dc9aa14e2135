"""The step-integrity guard over sharded leaves, ZeRO stripes and the
staged DCN exchange (horovod_tpu_torch/optimizers.py,
ops/step_program.py, ops/collectives.py ``reduced_health``,
elastic/state.py), on gloo ranks (tests/torch_ranks.py, each rank a
process running tests/torch_guard_workers.py).

The specs are the JAX package's: its expert- and model-sharded health
rows reduced over the leaves' missing axes and its resident stripe's
row reduced over every mesh axis (horovod_tpu/ops/step_program.py
:459-546), tests/test_moe.py::test_moe_guard_program_identical_without_fault,
and tests/chaos_smoke.py's second run (``run_dcn_chaos``).

Tolerances: a healthy guarded run equals the unguarded one bit for bit;
a skipped step leaves every gated tensor bit for bit; a rollback
restores the commit bit for bit; the chaos run's ranks end bit for bit
equal; the int8 DCN hop saves at least 40% of its raw bytes
(chaos_smoke.py's bound).
"""

import math

import numpy as np
import pytest

from torch_ranks import spawn_ranks
import torch_guard_workers as workers


def _inputs(seed=0, batches=4, ranks=4):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w1": (rng.standard_normal((6, 13)) * 0.5).astype(
                       np.float32),
                   "b1": np.zeros(13, np.float32),
                   "w2": (rng.standard_normal((13, 3)) * 0.5).astype(
                       np.float32),
                   "b2": np.zeros(3, np.float32)},
        "x": [rng.standard_normal((4 * ranks, 6)).astype(np.float32)
              for _ in range(batches)],
        "y": [rng.standard_normal((4 * ranks, 3)).astype(np.float32)
              for _ in range(batches)],
    }


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


# ----------------------------------- repair: rows over the shard axes

@pytest.mark.parametrize("kind,env", [
    ("expert", {"HOROVOD_EXPERT_PARALLEL": "2"}),
    ("model", {"HOROVOD_MODEL_PARALLEL": "2"}),
])
def test_a_nan_in_one_ranks_sharded_leaf_skips_every_rank(kind, env):
    """A NaN in rank 0's bucket of the sharded leaf only (its exchange
    never leaves the rank at ep 2 / tp 2 over 2 ranks): every rank skips
    that step, eagerly and in the compiled step, and the replicated
    leaves stay bitwise equal across the ranks. With no fault the
    guarded compiled run equals the plain one bitwise."""
    out = spawn_ranks(2, workers.sharded_leaves, _inputs(ranks=2), kind,
                      env=dict(env, HOROVOD_GUARD="1"))
    mode = "moe" if kind == "expert" else "spec"
    for form in ("eager", "compiled"):
        for r in (0, 1):
            assert out[r][f"{form}:mode"] == mode
            assert out[r][f"{form}:verdicts"] == ["apply", "skip", "apply"]
        for k in ("b1", "b2", "w1"):
            np.testing.assert_array_equal(out[0][f"{form}:params"][k],
                                          out[1][f"{form}:params"][k])
    for r in (0, 1):
        assert out[r]["guarded:verdict"]["action"] == "apply"
        assert out[r]["plain:verdict"] is None
        assert _equal(out[r]["plain"], out[r]["guarded"])


# ------------------------------------------------ the guard over ZeRO

CASES = [
    ("zero1", {"zero_stage": 1}),
    ("zero2", {"zero_stage": 2}),
    ("zero3", {"zero_stage": 3}),
    ("spec_zero2", {"zero_stage": 2, "expert_keys": ("w2",)}),
    ("zero2_int8", {"zero_stage": 2, "dcn_compression": "int8",
                    "dcn_local_size": 2}),
    ("dcn0_int8", {"dcn_compression": "int8", "dcn_local_size": 2}),
]
EXCHANGE = {"zero1": "zero1", "zero2": "zero2", "zero3": "zero3",
            "spec_zero2": "spec", "zero2_int8": "zero2",
            "dcn0_int8": "inline"}


@pytest.fixture(scope="module")
def zero_ranks():
    cases = [(name, kw, compiled) for name, kw in CASES
             for compiled in (False, True)]
    return spawn_ranks(4, workers.zero_guard, _inputs(), cases,
                       env={"HOROVOD_EXPERT_PARALLEL": "2"}, timeout=240)


def _tags():
    return [f"{name}:{form}" for name, _ in CASES
            for form in ("eager", "compiled")]


@pytest.mark.parametrize("tag", _tags())
def test_a_healthy_guarded_zero_step_equals_the_plain_one(zero_ranks, tag):
    """Four healthy Adam steps under HOROVOD_GUARD give the unguarded
    run's parameters bit for bit on every rank; the compiled step runs
    its guarded program and folds an apply."""
    for out in zero_ranks:
        assert out[f"{tag}:exchange"] == EXCHANGE[tag.split(":")[0]]
        assert _equal(out[f"{tag}:plain"], out[f"{tag}:guarded"])
        if tag.endswith("compiled"):
            assert out[f"{tag}:guarded:verdict"]["action"] == "apply"
            assert out[f"{tag}:sig"] == ["health"]


@pytest.mark.parametrize("tag", _tags())
def test_a_nan_step_leaves_every_gated_tensor(zero_ranks, tag):
    """A NaN on rank 0 alone (one gradient element eagerly: it lands in
    one rank's stripe; the whole backward in the compiled step): every
    rank skips, and the parameters, the stripe, the base optimizer's
    state and the DCN residual are bit for bit as before the step."""
    for out in zero_ranks:
        before, after, verdicts = out[f"{tag}:nan"]
        assert verdicts == ["skip"]
        assert _equal(before, after)
        assert before["state"], "the state exists before the NaN step"
        if "int8" in tag:
            assert "residual" in before


@pytest.mark.parametrize("tag", _tags())
def test_the_third_bad_step_rolls_back_to_the_commit(zero_ranks, tag):
    """Three bad steps after a commit: skip, skip with the rate backed
    off (the stripe's param group), rollback, and the gated tensors are
    the commit's again, the DCN residual zeroed."""
    for out in zero_ranks:
        assert out[f"{tag}:lr"] == 1e-2 * 0.5
        committed, now, actions = out[f"{tag}:rollback"]
        assert actions == ["skip", "skip", "rollback"]
        residual = now.pop("residual", None)
        committed.pop("residual", None)
        assert _equal(committed, now)
        if "int8" in tag:
            assert residual is not None and not residual.any()


def test_replicated_parameters_agree_across_ranks(zero_ranks):
    """The 1-D ladder's guarded runs leave every rank the same
    parameters (the stripe's verdict is one for all)."""
    for tag in _tags():
        if tag.startswith("spec"):
            continue
        for out in zero_ranks[1:]:
            assert _equal(out[f"{tag}:guarded"],
                          zero_ranks[0][f"{tag}:guarded"]), tag


@pytest.mark.parametrize("stage", [2, 3])
def test_a_zero_guard_callback_probes_a_resident_stripe_striped(
        monkeypatch, stage):
    """GuardCallback over a ZeRO optimizer: where the stripe is resident
    (a compiled zero3 step) it probes the stripe with the striped
    divergence probe; below zero3 the parameters are whole on every rank
    and nothing is probed unless the caller hands them over."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.callbacks import GuardCallback
    monkeypatch.setenv("HOROVOD_GUARD", "1")
    monkeypatch.setenv("HOROVOD_GUARD_DIVERGENCE_INTERVAL", "1")
    hvd.init(device="cpu")
    try:
        inp = _inputs(ranks=1)
        model = workers._Net(inp["params"])
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), zero_stage=stage)
        step = hvd.compiled_train_step(model.loss, opt)
        if step._resident:
            step.shard_params()
        step(*workers._batch(inp, 0, 0))
        probes = []
        monkeypatch.setattr(hvd.guard.get(), "check_divergence",
                            lambda params, striped=False:
                            probes.append((params, striped)))
        GuardCallback(optimizer=opt).on_batch_end(0)
        if stage == 3:
            ((params, striped),) = probes
            assert striped and torch.equal(params, opt.stripe.detach())
        else:
            assert probes == []
        step.finish()
    finally:
        hvd.shutdown()


# ------------------------------------------------- the DCN chaos run

def test_the_dcn_chaos_run_detects_rolls_back_and_reconverges():
    """tests/chaos_smoke.py's second run over 2 gloo ranks: the compiled
    zero2 step, int8 DCN compression, every byte over the DCN hop. A
    finite corruption of rank 1's parameters before step 2 passes the
    gate; the divergence probe finds it on both ranks, which roll back
    to the last commit, zero the residual, and end bit for bit equal,
    with the DCN wire bytes at least 40% below raw."""
    out = spawn_ranks(2, workers.dcn_chaos, _inputs(ranks=2), env={
        "HOROVOD_GUARD": "1", "HOROVOD_GUARD_DIVERGENCE_INTERVAL": "1",
        "HOROVOD_GUARD_INJECT":
            "corrupt,name=chaos.dcn,step=2,count=1,rank=1"})
    r0, r1 = out
    for r in out:
        assert math.isfinite(r["loss"])
        assert r["exchange"] == "zero2"
        assert r["divergence"] == 1.0 and r["divergence_step"] == 2
        assert r["repairs"] == 1.0
        assert r["residual_committed"] > 0.0
        assert r["residual_after_reset"] == 0.0
        assert r["fallback_steps"] == 0
        assert r["dcn_saved_frac"] >= 0.4
    assert r1["inject_corrupt"] == 1.0 and r0["inject_corrupt"] == 0.0
    assert _equal(r0["w"], r1["w"])
