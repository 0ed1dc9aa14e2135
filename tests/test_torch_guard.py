"""The port's step-integrity guard (horovod_tpu_torch/guard,
ops/collectives.py's health rows, the guarded optimizer, engine and
compiled step) against the JAX package's.

Tolerances: the chaos grammar, the ladder's verdicts and ``finite`` are
exact; ``l2`` is held within rtol 1e-6 (f32 sums in another order);
``parameter_digest`` within rtol 1e-12 (f64 sums in another order; the
port's digest is compared bitwise across its own replicas); a guarded
compiled step with an injected NaN skips the step the JAX package's
skips, its parameters within the SGD band of
tests/test_torch_step_program.py (rtol 2e-5, atol 1e-6), and a healthy
guarded step equals the unguarded one bit for bit.
"""

import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu import guard as jguard
from horovod_tpu.config import Config as JConfig
from horovod_tpu.guard import inject as jinject
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu_torch import guard as tguard
from horovod_tpu_torch.config import Config as TConfig
from horovod_tpu_torch.exceptions import TransientCollectiveError
from horovod_tpu_torch.guard import inject as tinject
from horovod_tpu_torch.ops import collectives as tcoll

from torch_ranks import spawn_ranks
import torch_elastic_workers as workers

L2_RTOL = 1e-6
DIGEST_RTOL = 1e-12
SGD_RTOL, SGD_ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh_runtime():
    yield
    hvd.shutdown()
    jhvd.shutdown()


def _init(monkeypatch, **env):
    hvd.shutdown()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    hvd.init(device="cpu")


# ------------------------------------------------------- spec grammar

SPECS = ["nan,name=hvd.grads.0,step=2,rank=0; fail,count=3 ;"
         "delay,seconds=0.5,op=allgather;corrupt,name=w",
         "", " ; ; ", "nan,count=2,step=1", "corrupt,rank=3,step=0"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_the_reference(spec):
    got = [s.describe() | {"seconds": s.seconds}
           for s in tinject.parse(spec)]
    want = [s.describe() | {"seconds": s.seconds}
            for s in jinject.parse(spec)]
    assert got == want


@pytest.mark.parametrize("bad", ["frobnicate,step=1", "nan,bogus=1",
                                 "nan,step", "nan,step=two"])
def test_parse_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jinject.parse(bad)
    with pytest.raises(ValueError):
        tinject.parse(bad)


def test_occurrence_window_matches_the_reference():
    t = tinject.InjectionSpec("nan", step=2, count=2)
    j = jinject.InjectionSpec("nan", step=2, count=2)
    for key in ("k", "k", "other", "k", "k", "other", "other", "k"):
        assert t._fire(key) == j._fire(key)


def test_injector_hooks():
    arr = torch.ones(4)
    inj = tinject.Injector(tinject.parse("nan,name=t,rank=1"), 0)
    assert inj.on_enqueue("t.0", arr) is arr
    inj = tinject.Injector(tinject.parse("nan,name=t"), 0)
    out = inj.on_enqueue("t.0", arr)
    assert torch.isnan(out[0]) and not torch.isnan(arr).any()
    assert inj.on_enqueue("t.0", arr) is arr
    iarr = torch.ones(4, dtype=torch.int32)
    assert tinject.Injector(tinject.parse("nan"), 0).on_enqueue(
        "i", iarr) is iarr
    rows = torch.ones(2, 4)
    inj = tinject.Injector(tinject.parse("corrupt,name=w"), 0)
    out = inj.on_rows(rows, names=("w.0", "b.0"))
    assert not torch.isfinite(out.view(-1)[:2]).any()
    assert torch.isfinite(rows).all()
    inj = tinject.Injector(tinject.parse("fail,op=allreduce,count=1"), 0)
    with pytest.raises(TransientCollectiveError):
        inj.on_dispatch("allreduce")
    inj.on_dispatch("allreduce")
    inj = tinject.Injector(tinject.parse("nan,name=hvd.step,step=1"), 0)
    assert not inj.on_step_nan("other")
    assert [inj.on_step_nan("hvd.step") for _ in range(3)] == [
        False, True, False]


# ---------------------------------------------------------- health rows

def _rows_case(seed):
    rng = np.random.default_rng(seed)
    row = rng.standard_normal(300).astype(np.float32)
    if seed % 3 == 1:
        row[7] = np.nan
    if seed % 3 == 2:
        row[150] = np.inf
        row[151] = -np.inf
    segs = ((0, 100, (10, 10), "<f4", True, None),
            (100, 120, (120,), "<f4", True, None),
            (220, 80, (8, 10), "<f4", True, None))
    return row, segs


@pytest.mark.parametrize("seed", range(6))
def test_segment_and_tree_health_match_the_reference(seed):
    row, segs = _rows_case(seed)
    got = tcoll.segment_health(torch.from_numpy(row), segs).numpy()
    want = np.asarray(jcoll.segment_health(jnp.asarray(row), segs))
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=L2_RTOL)
    leaves = [row[o:o + c].reshape(s) for o, c, s, *_ in segs]
    got = tcoll.tree_health([torch.from_numpy(x) for x in leaves]).numpy()
    want = np.asarray(jcoll.tree_health([jnp.asarray(x) for x in leaves]))
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=L2_RTOL)
    assert bool(tcoll.health_ok(torch.from_numpy(got))) == \
        bool(np.all((want[:, 0] >= 0.5) & np.isfinite(want[:, 1])))


# -------------------------------------------------------------- ladder

class _FakeState:
    def __init__(self):
        self._commits = 5
        self.restored = 0

    def restore(self):
        self.restored += 1


# (bucket name, finite, norm) notes per step; None: a healthy step
STREAM = [[], [("g.0", False, float("nan"))], [("g.0", True, float("inf"))],
          [("g.1", False, 1.0)], [], [("g.2", False, 2.0)], [],
          [("a", False, 1.0), ("b", True, float("nan"))],
          [("a", False, 1.0)], [("c", False, 1.0)], [("d", False, 1.0)]]


@pytest.mark.parametrize("limit,backoff", [(3, 2), (2, 1), (4, 4)])
def test_ladder_verdicts_match_the_reference(limit, backoff):
    """The same health stream through both monitors: the same verdicts
    (skip, back-off with its rates, rollback) step for step."""
    kw = dict(guard=True, guard_bad_step_limit=limit,
              guard_lr_backoff_steps=backoff, guard_lr_backoff_factor=0.5)
    mons, opts, states = [], [], []
    for cfg, mod in ((TConfig(**kw), tguard), (JConfig(**kw), jguard)):
        m = mod.GuardMonitor(cfg)
        opt = types.SimpleNamespace(lr=0.4)
        st = _FakeState()
        m.attach_optimizer(opt)
        m.attach_state(st)
        mons.append(m)
        opts.append(opt)
        states.append(st)
    for notes in STREAM:
        verdicts = []
        for m in mons:
            for name, finite, norm in notes:
                m.note_bucket(name, finite, norm)
            verdicts.append(m.end_step())
        assert verdicts[0] == verdicts[1]
        assert opts[0].lr == opts[1].lr
        assert states[0].restored == states[1].restored


def test_device_health_folds_as_the_reference():
    rows = np.array([[1.0, 2.5], [0.0, 1.0]], np.float32)
    more = np.array([[1.0, np.nan]], np.float32)
    t = tguard.GuardMonitor(TConfig(guard=True))
    j = jguard.GuardMonitor(JConfig(guard=True))
    t.note_device_health(("a", "b"), torch.from_numpy(rows))
    t.note_device_health(("c",), torch.from_numpy(more))
    j.note_device_health(("a", "b"), rows)
    j.note_device_health(("c",), more)
    assert t.end_step() == j.end_step()


def test_tensor_lr_backs_off_in_place():
    """A tensor lr is filled in place (a captured step reads it there)."""
    m = tguard.GuardMonitor(TConfig(guard=True, guard_lr_backoff_steps=1))
    p = torch.nn.Parameter(torch.ones(2))
    lr = torch.tensor(0.5)
    opt = torch.optim.AdamW([p], lr=lr)
    m.attach_optimizer(opt)
    m.note_bucket("g", False, 1.0)
    v = m.end_step()
    assert v["lr_backoff"] == {"from": 0.5, "to": 0.25}
    assert opt.param_groups[0]["lr"] is lr and float(lr) == 0.25


@pytest.mark.parametrize("seed", range(3))
def test_parameter_digest_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((7, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "e": np.zeros((0, 3), np.float32)}
    got = tguard.parameter_digest({k: torch.from_numpy(v)
                                   for k, v in params.items()})
    want = jguard.parameter_digest(params)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1:], want[1:], rtol=DIGEST_RTOL)
    twin = tguard.parameter_digest({k: torch.from_numpy(v.copy())
                                    for k, v in params.items()})
    assert got.tobytes() == twin.tobytes()
    params["b"][0] += 1e-3
    assert tguard.parameter_digest(
        {k: torch.from_numpy(v) for k, v in params.items()}).tobytes() != \
        got.tobytes()


def test_divergence_probe_at_one_rank(monkeypatch):
    _init(monkeypatch, HOROVOD_GUARD="1",
          HOROVOD_GUARD_DIVERGENCE_INTERVAL="2")
    model = torch.nn.Linear(3, 2)
    m = hvd.guard.get()
    assert m.check_divergence(model) is None      # cadence: no probe
    assert m.check_divergence(model) is None      # probe: one replica


# ------------------------------------------------- the compiled step

def _np_params():
    rng = np.random.RandomState(0)
    return {"w1": (rng.randn(4, 8) * 0.3).astype(np.float32),
            "b1": np.zeros((8,), np.float32),
            "w2": (rng.randn(8, 1) * 0.3).astype(np.float32),
            "b2": np.zeros((1,), np.float32)}


def _batches(steps, nan_at=None):
    out = []
    for i in range(steps):
        rng = np.random.RandomState(1 + i)
        x = rng.randn(16, 4).astype(np.float32)
        y = rng.randn(16, 1).astype(np.float32)
        if i == nan_at:
            x[3, 1] = np.nan
        out.append((x, y))
    return out


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.p = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v))
             for k, v in _np_params().items()})

    def loss(self, x, y):
        p = self.p
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return torch.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def _jax_loss(params, x, y):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] + params["b2"] - y) ** 2)


def _run_port(batches, distributed=True, adam=False, lr=0.05):
    model = _MLP()
    opt = (torch.optim.AdamW(model.parameters(), lr=torch.tensor(lr))
           if adam else torch.optim.SGD(model.parameters(), lr=lr))
    if distributed:
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
    step = hvd.compiled_train_step(model.loss, opt)
    step.verdicts = []
    for x, y in batches:
        step(torch.from_numpy(x), torch.from_numpy(y))
        mon = hvd.guard.get()
        v = None if mon is None else mon.last_verdict
        step.verdicts.append(None if v is None else v["action"])
    return model, opt, step


def _params(model):
    return {k: v.detach().numpy().copy() for k, v in model.p.items()}


@pytest.mark.parametrize("distributed", [True, False])
def test_guarded_step_with_nan_skips_as_the_reference(monkeypatch,
                                                      distributed):
    """A NaN batch at step 2: the JAX package's guarded compiled step
    (8 virtual devices) skips it in-graph, and so does the port's (its
    DistributedOptimizer's rows, or a plain optimizer's); the verdicts
    agree step for step and the parameters lie within the SGD band. The
    port's HOROVOD_GUARD_INJECT seed at step 2 gives the NaN batch's
    bits."""
    batches = _batches(5, nan_at=2)
    monkeypatch.setenv("HOROVOD_GUARD", "1")
    jhvd.init()
    jstep = jhvd.compiled_train_step(_jax_loss, optax.sgd(0.05))
    jparams = {k: jnp.asarray(v) for k, v in _np_params().items()}
    jstate = jstep.init(jparams)
    jverdicts = []
    for x, y in batches:
        jparams, jstate, _ = jstep(jparams, jstate, jnp.asarray(x),
                                   jnp.asarray(y))
        v = jguard.get().last_verdict
        jverdicts.append(None if v is None else v["action"])
    jverdicts.append(jstep.finish()["action"])
    _init(monkeypatch)
    model, _, step = _run_port(batches, distributed)
    got = _params(model)
    assert step.verdicts + [step.finish()["action"]] == jverdicts == [
        None, "apply", "apply", "skip", "apply", "apply"]
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=SGD_RTOL,
                                   atol=SGD_ATOL, err_msg=k)
    # the chaos seed at the same step: the NaN batch's bits
    _init(monkeypatch, HOROVOD_GUARD_INJECT="nan,name=hvd.step,step=2")
    seeded, _, sstep = _run_port(_batches(5), distributed)
    assert sstep.finish()["ok"]
    for k, v in _params(seeded).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    assert hvd.metrics.GUARD_SKIPPED_STEPS.value() >= 2


def test_healthy_guarded_step_equals_the_plain_step(monkeypatch):
    _init(monkeypatch)
    plain, _, _ = _run_port(_batches(4), adam=True)
    _init(monkeypatch, HOROVOD_GUARD="1")
    guarded, opt, step = _run_port(_batches(4), adam=True)
    assert step.finish()["ok"]
    for k, v in _params(plain).items():
        np.testing.assert_array_equal(_params(guarded)[k], v, err_msg=k)
    (sig,) = step._signatures
    assert sig[1] == "health"


def test_skip_holds_parameters_and_adamw_state(monkeypatch):
    """The injected NaN's step leaves the parameters and AdamW's step
    count and moments bitwise as they were."""
    _init(monkeypatch, HOROVOD_GUARD="1",
          HOROVOD_GUARD_INJECT="nan,name=hvd.step,step=2")
    model = _MLP()
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=torch.tensor(0.01)),
        named_parameters=model.named_parameters())
    step = hvd.compiled_train_step(model.loss, opt)
    batches = [tuple(map(torch.from_numpy, b)) for b in _batches(4)]

    def snap():
        return ([p.detach().clone() for p in model.parameters()],
                [v.clone() for p in model.parameters()
                 for _, v in sorted(opt.state[p].items())])

    step(*batches[0])
    step(*batches[1])
    before = snap()
    step(*batches[2])                  # poisoned
    after = snap()
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert torch.equal(a, b)
    verdict = step._flush_guard(hvd.guard.get())
    assert verdict["action"] == "skip"
    step(*batches[3])
    assert not all(torch.equal(a, b) for a, b in zip(before[0], snap()[0]))


def test_backoff_reaches_the_step_and_rollback_restores_the_commit(
        monkeypatch, tmp_path):
    """Two bad steps back the tensor lr off (the next step's update uses
    it); three roll back to the State commit, in place and bitwise (the
    rollback's post-mortem lands in the diag dir)."""
    _init(monkeypatch, HOROVOD_DIAG_DIR=str(tmp_path),
          HOROVOD_GUARD="1", HOROVOD_GUARD_LR_BACKOFF_STEPS="2",
          HOROVOD_GUARD_BAD_STEPS="3",
          # calls 2-3, then 5-7: the second spec counts only the calls
          # the first one does not fire at (0, 1, 4, 5, ...)
          HOROVOD_GUARD_INJECT="nan,name=hvd.step,step=2,count=2;"
                               "nan,name=hvd.step,step=3,count=3")
    model = _MLP()
    lr = torch.tensor(0.01)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=lr),
        named_parameters=model.named_parameters())
    state = hvd.elastic.State(model=model, optimizer=opt)
    mon = hvd.guard.get()
    mon.attach_optimizer(opt)
    mon.attach_state(state)
    step = hvd.compiled_train_step(model.loss, opt)
    batch = tuple(map(torch.from_numpy, _batches(1)[0]))
    step(*batch)
    step(*batch)
    state.commit()
    storage = [p.data_ptr() for p in model.parameters()]
    committed = [p.detach().clone() for p in model.parameters()]
    step(*batch)                        # bad 1
    step(*batch)                        # bad 2: back-off at the next call
    held = ([p.detach().clone() for p in model.parameters()],
            [{k: v.clone() for k, v in opt.state[p].items()}
             for p in model.parameters()])
    step(*batch)                        # healthy, at lr / 2
    half = float(np.float32(0.01)) * 0.5
    assert float(lr) == half
    assert mon.last_verdict["lr_backoff"] == {
        "from": float(np.float32(0.01)), "to": half}
    # the step read the new rate: AdamW at lr / 2 from the held state
    # on the step's own gradients gives its parameters
    for rate, same in ((half, True), (0.01, False)):
        ps = [torch.nn.Parameter(p.clone()) for p in held[0]]
        ref = torch.optim.AdamW(ps, lr=torch.tensor(rate))
        for q, p, st in zip(ps, model.parameters(), held[1]):
            q.grad = p.grad.clone()
            ref.state[q] = {k: v.clone() for k, v in st.items()}
        ref.step()
        assert all(torch.allclose(q, p, rtol=1e-6, atol=0)
                   for q, p in zip(ps, model.parameters())) == same
    for _ in range(3):
        step(*batch)                    # bad 3, 4, 5: rollback
    verdict = step.finish()
    assert verdict["action"] == "rollback"
    assert [p.data_ptr() for p in model.parameters()] == storage
    for p, c in zip(model.parameters(), committed):
        assert torch.equal(p.detach(), c)
    assert (tmp_path / "flight-rank0.json").exists()


def test_eager_distributed_optimizer_skips(monkeypatch):
    _init(monkeypatch, HOROVOD_GUARD="1",
          HOROVOD_GUARD_INJECT="nan,name=grads.bucket,step=1")
    model = _MLP()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters())
    x, y = map(torch.from_numpy, _batches(1)[0])
    actions = []
    for _ in range(3):
        before = [p.detach().clone() for p in model.parameters()]
        opt.zero_grad()
        model.loss(x, y).backward()
        opt.step()
        actions.append(hvd.guard.get().last_verdict["action"])
        if actions[-1] == "skip":
            assert all(torch.equal(a, p) for a, p in
                       zip(before, model.parameters()))
    assert actions == ["apply", "skip", "apply"]
    assert opt.guard_health.shape == (4, 2)


def test_engine_nan_and_guarded_apply_updates(monkeypatch):
    """A poisoned engine submission: its reduced bucket's rows go to the
    monitor, and guarded_apply_updates skips the step."""
    _init(monkeypatch, HOROVOD_GUARD="1",
          HOROVOD_GUARD_INJECT="nan,name=grad.w,step=1")
    w = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.SGD([w], lr=0.5)
    applied = []
    for _ in range(3):
        w.grad = torch.ones(3)
        hvd.allreduce_(w.grad, name="grad.w")
        applied.append(hvd.guarded_apply_updates(opt))
    assert applied == [True, False, True]
    assert torch.equal(w.detach(), torch.zeros(3))


def test_guarded_wire_retries_an_injected_failure(monkeypatch):
    _init(monkeypatch, HOROVOD_GUARD_RETRY="2",
          HOROVOD_GUARD_RETRY_BASE_SECONDS="0.001",
          HOROVOD_GUARD_INJECT="fail,op=allreduce,count=1")
    before = hvd.metrics.GUARD_RETRIES.value()
    out = hvd.allreduce(torch.ones(2), name="retry.me")
    assert torch.equal(out, torch.ones(2))
    assert hvd.metrics.GUARD_RETRIES.value() - before == 1


def test_guarded_wire_default_is_fail_fast(monkeypatch):
    _init(monkeypatch, HOROVOD_GUARD_INJECT="fail,op=allreduce,count=1")
    with pytest.raises(TransientCollectiveError):
        hvd.allreduce(torch.ones(2), name="fail.fast")


def test_guard_inert_by_default(monkeypatch):
    _init(monkeypatch)
    assert hvd.guard.get() is None and hvd.guard.inject.get() is None
    model = _MLP()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters())
    x, y = map(torch.from_numpy, _batches(1)[0])
    model.loss(x, y).backward()
    opt.step()
    assert opt.guard_health is None


def test_two_ranks_agree_on_the_verdict():
    """Rank 0's bucket poisoned at step 1 over 2 gloo ranks: both skip it
    (the verdict comes from the reduced buffer), identical parameters."""
    out = spawn_ranks(2, workers.guard_verdict_agreement, 3, env={
        "HOROVOD_GUARD": "1",
        "HOROVOD_GUARD_INJECT": "nan,name=grads.bucket,step=1,rank=0"},
        timeout=60)
    assert [o["verdicts"] for o in out] == [["apply", "skip", "apply"]] * 2
    for a, b in zip(out[0]["params"], out[1]["params"]):
        assert torch.equal(a, b)


def test_two_ranks_repair_a_drifted_replica():
    out = spawn_ranks(2, workers.divergence_repair, env={
        "HOROVOD_GUARD": "1", "HOROVOD_GUARD_DIVERGENCE_INTERVAL": "1"},
        timeout=60)
    for o in out:
        assert o["same"] is None and o["repaired"] and o["striped"] is None
        assert o["divergence"] == 1
    for a, b in zip(out[0]["params"], out[1]["params"]):
        assert torch.equal(a, b)
