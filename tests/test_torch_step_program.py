"""The port's compiled hot loop (horovod_tpu_torch/ops/step_program.py)
against the JAX package's (horovod_tpu/ops/step_program.py), on the CPU.

On the CPU nothing is captured: a step program is its step function run
as it is, under the same signatures, cache counters and fallback reasons
as on a card (the captured graphs are checked on the card, in
tests/test_torch_cuda_graphs.py). The cases follow the reference's
tests/test_step_program.py: parity with the eager step, the host-mode
and disabled fallbacks, DistributedOptimizer auto-decomposition, the
refusals, the steady-state hit rate, the churn limit and the cold start
after a re-init. The counts cases run the reference's own tiny workload
through both packages and compare the counters one for one.

Tolerances:
- compiled against the port's eager step: bitwise (the same ops in the
  same order);
- against the JAX package's ``compiled_train_step`` after 3 AdamW steps
  of the tiny transformer (f32, ``optax.adamw`` against
  ``torch.optim.AdamW`` with its betas, eps and weight decay):
  ``ADAM_ATOL`` 2e-6, tests/test_torch_training.py's band. The JAX step
  averages the mean loss of 8 one-row shards, the port takes the mean
  of the whole batch, so the gradients differ in summation order only;
- the reference's SGD workload: 2e-5 relative, 1e-6 absolute, its own
  band (tests/test_step_program.py::_assert_tree_close).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.models.transformer as jtfm
import horovod_tpu_torch as hvd
from horovod_tpu_torch import metrics
from horovod_tpu_torch.config import Config
from horovod_tpu_torch.models import transformer as tfm

ADAM_ATOL = 2e-6
LR, WD = 1e-3, 1e-4
SGD_RTOL, SGD_ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh_runtime():
    """The step's knobs are read at init(): each test starts its own
    session and ends both packages' sessions."""
    yield
    hvd.shutdown()
    jhvd.shutdown()


def _init(monkeypatch=None, **env):
    hvd.shutdown()
    if monkeypatch is not None:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    hvd.init(device="cpu")


def _metric(name, key=""):
    return metrics.snapshot()[name]["values"].get(key, 0.0)


# ------------------------------------------ the reference's tiny workload


def _numpy_params():
    rng = np.random.RandomState(0)
    return {"w1": (rng.randn(4, 8) * 0.3).astype(np.float32),
            "b1": np.zeros((8,), np.float32),
            "w2": (rng.randn(8, 1) * 0.3).astype(np.float32),
            "b2": np.zeros((1,), np.float32)}


def _batch(rows=16, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, 4).astype(np.float32),
            rng.randn(rows, 1).astype(np.float32))


def _jax_loss_fn(params, x, y):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] + params["b2"] - y) ** 2)


class _MLP(torch.nn.Module):
    """The reference's tiny regression model, parameter for parameter."""

    def __init__(self):
        super().__init__()
        self.p = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v))
             for k, v in _numpy_params().items()})

    def loss(self, x, y):
        p = self.p
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return torch.mean((h @ p["w2"] + p["b2"] - y) ** 2)

    def numpy(self):
        return {k: v.detach().numpy().copy() for k, v in self.p.items()}


def _sgd(model, distributed=False):
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    if distributed:
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
    return opt


def _run_port(step, steps=5, rows=(16,)):
    losses = []
    for i in range(steps):
        x, y = _batch(rows=rows[i % len(rows)], seed=1 + i)
        losses.append(float(step(torch.from_numpy(x), torch.from_numpy(y))))
    return losses


def _run_jax(step, steps=5, rows=(16,)):
    params = jax.tree.map(jnp.asarray, _numpy_params())
    opt_state = step.init(params)
    for i in range(steps):
        x, y = _batch(rows=rows[i % len(rows)], seed=1 + i)
        params, opt_state, _ = step(params, opt_state, jnp.asarray(x),
                                    jnp.asarray(y))
    return {k: np.asarray(v) for k, v in params.items()}


def _counts(step):
    return (step.compiled_steps, step.fallback_steps, step.cache_hits,
            step.cache_misses)


def _assert_close(got, want, rtol=SGD_RTOL, atol=SGD_ATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# ------------------------------------------------------------------ parity


def test_compiled_matches_eager_step_bitwise():
    _init()
    model, ref = _MLP(), _MLP()
    step = hvd.compiled_train_step(model.loss, _sgd(model))
    assert step._exchange == "psum"
    got = _run_port(step)
    opt = _sgd(ref)
    want = []
    for i in range(5):
        x, y = (torch.from_numpy(a) for a in _batch(seed=1 + i))
        opt.zero_grad(set_to_none=True)
        loss = ref.loss(x, y)
        loss.backward()
        opt.step()
        want.append(float(loss.detach()))
    assert got == want
    for k, v in ref.numpy().items():
        np.testing.assert_array_equal(model.numpy()[k], v, err_msg=k)
    assert _counts(step) == (5, 0, 4, 1)


def test_compiled_matches_jax_compiled_step_sgd():
    _init()
    model = _MLP()
    step = hvd.compiled_train_step(model.loss, _sgd(model))
    _run_port(step)
    jhvd.init()
    jstep = jhvd.compiled_train_step(_jax_loss_fn, optax.sgd(0.05))
    want = _run_jax(jstep)
    _assert_close(model.numpy(), want)
    assert _counts(step) == (jstep.compiled_steps, jstep.fallback_steps,
                             jstep.cache_hits, jstep.cache_misses)


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{n}": x for n, x in layer.items()})
    return out


def test_transformer_matches_jax_compiled_step_after_3_adamw_steps():
    """The flagship's code at a tiny size, flash attention (the JAX
    side's Pallas kernels in interpret mode), f32, DistributedOptimizer
    over AdamW: after 3 compiled steps every parameter within ADAM_ATOL
    of the JAX compiled step's."""
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                n_layers=2, d_ff=64, max_seq=16, positional="rope",
                attention_impl="flash", loss_chunk=8)
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, flash_interpret=True,
                                  **base)
    tcfg = tfm.TransformerConfig(dtype=torch.float32, **base)
    _init()
    lm = tfm.TransformerLM(tcfg, generator=torch.Generator().manual_seed(4),
                           device="cpu")
    jparams = jax.tree.map(jnp.asarray, tfm.params_to_numpy(lm.params))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), lr=LR, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=WD),
        named_parameters=lm.named_parameters())
    step = hvd.compiled_train_step(lm.loss, opt)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        tokens = rng.integers(0, 64, (8, 16))
        batches.append((tokens, np.roll(tokens, -1, axis=1)))
        step(*(torch.from_numpy(a) for a in batches[-1]))
    assert _counts(step) == (3, 0, 2, 1)

    jhvd.init()
    jstep = jhvd.compiled_train_step(
        lambda p, t, y: jtfm.loss_fn(p, t, y, jcfg),
        optax.adamw(LR, weight_decay=WD))
    opt_state = jstep.init(jparams)
    for tokens, targets in batches:
        jparams, opt_state, _ = jstep(jparams, opt_state,
                                      jnp.asarray(tokens),
                                      jnp.asarray(targets))
    got = _flat(tfm.params_to_numpy(lm.params))
    want = {k: np.asarray(v) for k, v in _flat(jparams).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ADAM_ATOL, rtol=0,
                                   err_msg=k)


# --------------------------------------------------------------- fallbacks


@pytest.mark.parametrize("env,reason", [
    ({"HOROVOD_DEVICE_RESIDENT": "0"}, "host_mode"),
    ({"HOROVOD_STEP_PROGRAM": "0"}, "disabled"),
    ({"HOROVOD_STEP_PROGRAM": "0", "HOROVOD_DEVICE_RESIDENT": "0"},
     "disabled"),
])
def test_fallbacks_run_the_eager_step_with_parity(monkeypatch, env, reason):
    """HOROVOD_DEVICE_RESIDENT=0 (host_mode) and HOROVOD_STEP_PROGRAM=0
    (disabled, which wins): every step runs eagerly under its reason,
    with the compiled step's numbers, as in the reference."""
    _init()
    compiled = _MLP()
    _run_port(hvd.compiled_train_step(compiled.loss, _sgd(compiled)))
    _init(monkeypatch, **env)
    before = _metric("hvd_step_fallback_total", f'reason="{reason}"')
    model = _MLP()
    step = hvd.compiled_train_step(model.loss, _sgd(model))
    _run_port(step)
    assert _counts(step) == (0, 5, 0, 0)
    assert _metric("hvd_step_fallback_total",
                   f'reason="{reason}"') == before + 5
    for k, v in compiled.numpy().items():
        np.testing.assert_array_equal(model.numpy()[k], v, err_msg=k)
    jhvd.init()
    jstep = jhvd.compiled_train_step(_jax_loss_fn, optax.sgd(0.05))
    _run_jax(jstep)
    assert _counts(step) == (jstep.compiled_steps, jstep.fallback_steps,
                             jstep.cache_hits, jstep.cache_misses)


def test_distributed_optimizer_auto_decomposes():
    """DistributedOptimizer under exchange='auto': its gradient hooks are
    the exchange, one all-reduce a step (one bucket), and the numbers
    equal the fused exchange in front of a plain optimizer."""
    _init()
    model, plain = _MLP(), _MLP()
    step = hvd.compiled_train_step(model.loss, _sgd(model, True))
    assert step._exchange == "hooks"
    stats = hvd.runtime.live_state().stats
    calls0 = stats.counter("allreduce")
    _run_port(step)
    assert stats.counter("allreduce") - calls0 == 5
    _run_port(hvd.compiled_train_step(plain.loss, _sgd(plain)))
    for k, v in plain.numpy().items():
        np.testing.assert_array_equal(model.numpy()[k], v, err_msg=k)


def test_exchange_buckets_replan_the_distributed_optimizer():
    _init()
    model = _MLP()
    opt = _sgd(model, True)
    assert len(opt.exchange_buckets) == 1
    step = hvd.compiled_train_step(model.loss, opt, exchange_buckets=2)
    assert len(opt.exchange_buckets) == 2
    stats = hvd.runtime.live_state().stats
    calls0 = stats.counter("allreduce")
    _run_port(step, steps=3)
    assert stats.counter("allreduce") - calls0 == 6


@pytest.mark.parametrize("kw,item", [
    ({"model_keys": ("w1",), "zero_stage": 1}, 6),
    ({"model_keys": ("w1",), "zero_stage": 3}, 6),
    ({"model_keys": ("w1",), "dcn_compression": "int8"}, 6),
    ({"model_keys": ("w1",)}, 6)])
def test_unported_layouts_raise_naming_their_item(kw, item):
    """The tensor-parallel layouts of ROADMAP.md item 6 (ported since),
    with every ZeRO stage and the staged exchange, on a runtime without
    a model mesh: the reference builds the optimizer and its compiled
    step refuses to run it (``_step_mesh``), the port refuses where the
    optimizer is built, in the reference's words. Nothing runs with the
    model axis dropped. tests/test_torch_tensor_parallel.py trains these
    layouts on the 3-D mesh."""
    assert item == 6
    jhvd.init()
    tx = jhvd.DistributedOptimizer(optax.sgd(0.05), **kw)
    step = jhvd.compiled_train_step(_jax_loss_fn, tx)
    params = jax.tree.map(jnp.asarray, _numpy_params())
    x, y = _batch()
    with pytest.raises(ValueError) as want:
        step(params, step.init(params), x, y)
    _init()
    model = _MLP()
    with pytest.raises(ValueError) as got:
        hvd.DistributedOptimizer(_sgd(model), **kw)
    assert str(got.value) == str(want.value)
    assert "HOROVOD_MODEL_PARALLEL" in str(got.value)


def test_a_dropped_step_leaves_the_program_cache():
    """A compiled step's program holds the step weakly: once the caller
    drops the step (and its model and optimizer), the session's cache
    holds no signature of it and nothing keeps the model or the
    optimizer alive (on a card, their tensors leave the card)."""
    import gc
    import weakref
    _init()
    model = _MLP()
    opt = _sgd(model, True)
    step = hvd.compiled_train_step(model.loss, opt)
    _run_port(step, steps=1)
    programs = hvd.runtime.live_state().programs
    (sig,) = step._signatures
    assert sig in programs._programs and len(programs) == 1
    refs = weakref.ref(model), weakref.ref(opt)
    del model, opt, step
    gc.collect()
    assert sig not in programs._programs and len(programs) == 0
    assert [r() for r in refs] == [None, None]


def test_guard_gates_a_zero_stripe(monkeypatch):
    """The guard over a ZeRO stripe (ROADMAP.md item 15's leftover, now
    ported): a guarded stage-1 step builds its own program, runs, and
    gates its stripe: a healthy step equals the unguarded one bitwise,
    and a NaN step leaves the stripe, the parameters and the state as
    they were."""
    def run(**env):
        _init(monkeypatch, **env)
        model = _MLP()
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=0.05),
            named_parameters=model.named_parameters(), zero_stage=1)
        step = hvd.compiled_train_step(model.loss, opt)
        _run_port(step, steps=2)
        return model, opt, step

    plain, _, _ = run()
    model, opt, step = run(HOROVOD_GUARD="1")
    (sig,) = step._signatures
    assert sig[1:3] == ("health", "zero1")
    assert step.finish()["ok"]
    for k, v in plain.numpy().items():
        np.testing.assert_array_equal(model.numpy()[k], v, err_msg=k)
    held = ([opt.stripe.detach().clone()]
            + [p.detach().clone() for p in model.parameters()]
            + [v.clone() for v in opt.state[opt.stripe].values()])
    monkeypatch.setenv("HOROVOD_GUARD_INJECT", "nan,name=hvd.step")
    hvd.guard.inject.install(Config.from_env())
    _run_port(step, steps=1)
    assert step.finish()["action"] == "skip"
    now = ([opt.stripe.detach()] + list(model.parameters())
           + list(opt.state[opt.stripe].values()))
    for a, b in zip(held, now):
        assert torch.equal(a, b.detach())


def test_rejects_multi_step_accumulation():
    """backward_passes_per_step > 1 hides the step the program would
    capture: refused at construction in the reference's words."""
    _init()
    model = _MLP()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.05),
                                   named_parameters=model.named_parameters(),
                                   backward_passes_per_step=2)
    with pytest.raises(ValueError, match=r"cannot introspect .*"
                                         r"backward_passes_per_step>1"):
        hvd.compiled_train_step(model.loss, opt)


# -------------------------------------------------------- cache discipline


def test_steady_state_cache_hit_rate():
    """12 same-shape steps: one miss, then hits; the session gauges
    mirror the object's counters, as the reference's."""
    _init()
    model = _MLP()
    step = hvd.compiled_train_step(model.loss, _sgd(model))
    compiled0 = _metric("hvd_step_compiled_total")
    _run_port(step, steps=12)
    assert (step.cache_misses, step.cache_hits) == (1, 11)
    assert step.cache_hit_rate >= 0.9
    programs = hvd.runtime.live_state().programs
    assert (programs.misses, programs.hits) == (1, 11) and len(programs) == 1
    assert _metric("hvd_step_program_cache_hits") == 11.0
    assert _metric("hvd_step_program_cache_misses") == 1.0
    assert _metric("hvd_step_compiled_total") == compiled0 + 12
    assert step.finish() is None


def test_shape_churn_limit_falls_back(monkeypatch):
    """Past HOROVOD_STEP_PROGRAM_CHURN_LIMIT distinct batch shapes a new
    shape runs eagerly (reason shape_churn); a seen one still hits. The
    counters equal the reference's on the same sequence."""
    _init(monkeypatch, HOROVOD_STEP_PROGRAM_CHURN_LIMIT="2")
    before = _metric("hvd_step_fallback_total", 'reason="shape_churn"')
    model = _MLP()
    step = hvd.compiled_train_step(model.loss, _sgd(model))
    rows = (16, 24, 32, 16)
    _run_port(step, steps=4, rows=rows)
    assert _counts(step) == (3, 1, 1, 2)
    assert _metric("hvd_step_fallback_total",
                   'reason="shape_churn"') == before + 1
    jhvd.init()
    jstep = jhvd.compiled_train_step(_jax_loss_fn, optax.sgd(0.05))
    _run_jax(jstep, steps=4, rows=rows)
    assert _counts(step) == (jstep.compiled_steps, jstep.fallback_steps,
                             jstep.cache_hits, jstep.cache_misses)


def test_elastic_reinit_cold_starts_cache():
    """shutdown() drops the session's programs; after init() the step
    object's first call is a miss again in a fresh cache."""
    _init()
    model = _MLP()
    step = hvd.compiled_train_step(model.loss, _sgd(model))
    _run_port(step, steps=3)
    old = hvd.runtime.live_state().programs
    assert (old.hits, old.misses) == (2, 1)
    _init()
    new = hvd.runtime.live_state().programs
    assert new is not old and len(old) == 0
    _run_port(step, steps=1)
    assert (new.hits, new.misses) == (0, 1)
    assert (step.cache_hits, step.cache_misses) == (2, 2)


def test_a_changed_hyperparameter_is_a_new_program():
    """A captured update bakes in the optimizer's scalars, so a new
    learning rate keys a new program rather than replaying a stale
    one."""
    _init()
    model = _MLP()
    opt = _sgd(model)
    step = hvd.compiled_train_step(model.loss, opt)
    _run_port(step, steps=2)
    opt.param_groups[0]["lr"] = 0.01
    _run_port(step, steps=2)
    assert (step.cache_misses, step.cache_hits) == (2, 2)


# ------------------------------------------------------ knobs and metrics


@pytest.mark.parametrize("env", [
    {},
    {"HOROVOD_STEP_PROGRAM": "0", "HOROVOD_DEVICE_RESIDENT": "1",
     "HOROVOD_STEP_PROGRAM_CHURN_LIMIT": "0",
     "HOROVOD_PROFILER_JIT_CALLBACKS": "1"},
    {"HOROVOD_STEP_PROGRAM": "1", "HOROVOD_DEVICE_RESIDENT": "0",
     "HOROVOD_STEP_PROGRAM_CHURN_LIMIT": "3"},
])
def test_knobs_read_the_reference_variables(monkeypatch, env):
    """The four knobs take the JAX package's variables, defaults and
    clamps (the churn limit is at least 1)."""
    from horovod_tpu.config import Config as JaxConfig
    from horovod_tpu_torch.config import Config
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = Config.from_env(), JaxConfig.from_env()
    for knob in ("step_program", "step_program_churn_limit",
                 "device_resident", "profiler_jit_callbacks"):
        assert getattr(got, knob) == getattr(want, knob), knob


def test_metric_families_carry_the_reference_names():
    import horovod_tpu.metrics as jmetrics
    for attr in ("STEP_PROGRAM_CACHE_HITS", "STEP_PROGRAM_CACHE_MISSES",
                 "STEP_COMPILED_TOTAL", "STEP_FALLBACK_TOTAL",
                 "SERVE_PROGRAM_CACHE_HITS", "SERVE_PROGRAM_CACHE_MISSES",
                 "SERVE_FALLBACK_STEPS"):
        got, want = getattr(metrics, attr), getattr(jmetrics, attr)
        assert (got.name, got.help, got.labelnames, got.kind) == (
            want.name, want.help, want.labelnames, want.kind), attr


# ------------------------------------------- sequence-parallel steps


def _sp_model(sp_impl, axis):
    cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                n_kv_heads=2, n_layers=2, d_ff=64,
                                max_seq=32, positional="rope",
                                attention_window=12, loss_chunk=8,
                                attention_impl="flash", sp_impl=sp_impl,
                                dtype=torch.float32)
    return tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu", axes=tfm.ShardAxes(sp=axis))


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_sp_step_compiles_as_the_eager_step(sp_impl):
    """The ring's and Ulysses' step over a local axis of 2 through
    ``compiled_train_step`` with AdamW: one signature (1 miss, then
    hits, no fallback) and, the program being its step run as it is on
    the CPU, the eager step's parameters bitwise after 3 steps (on a
    card: tests/test_torch_cuda_graphs.py)."""
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    _init()
    rng = np.random.default_rng(3)
    batches = [torch.from_numpy(rng.integers(0, 64, (2, 32)))
               for _ in range(3)]
    models = [_sp_model(sp_impl, RingAxis.local(2)) for _ in range(2)]
    opts = [torch.optim.AdamW(m.parameters(), lr=LR, weight_decay=WD)
            for m in models]
    step = hvd.compiled_train_step(models[0].loss, opts[0])
    for tokens in batches:
        targets = torch.roll(tokens, -1, dims=1)
        step(tokens, targets)
        opts[1].zero_grad(set_to_none=True)
        models[1].loss(tokens, targets).backward()
        opts[1].step()
    assert _counts(step) == (3, 0, 2, 1)
    for (name, a), (_, b) in zip(models[0].named_parameters(),
                                 models[1].named_parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_a_process_group_sp_step_refuses_capture(monkeypatch, sp_impl):
    """A step whose sequence axis spans a process group, while a CUDA
    graph captures it, raises naming the ROADMAP.md entry (gloo cannot
    be captured, NCCL needs a card a rank): the capture is simulated
    here, as the CPU has none."""
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    _init()
    model = _sp_model(sp_impl, RingAxis(2, (0,), group=object()))
    step = hvd.compiled_train_step(
        model.loss, torch.optim.AdamW(model.parameters(), lr=LR))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    tokens = torch.zeros((2, 16), dtype=torch.int64)
    with pytest.raises(NotImplementedError,
                       match="Waiting for several cards"):
        step(tokens, tokens)
