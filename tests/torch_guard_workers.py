"""What each gloo rank runs in tests/test_torch_zero_guard.py (through
tests/torch_ranks.py's ``spawn_ranks``): the step-integrity guard over
sharded leaves, ZeRO stripes and the staged DCN exchange. No JAX here:
every rank imports this module. Each function returns numpy arrays and
plain values."""

import os

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import guard
from horovod_tpu_torch.config import Config


class _Net(torch.nn.Module):
    """A 6 -> 13 -> 3 MLP whose parameters register in sorted order
    (b1, b2, w1, w2), as the JAX package's leaves; ``w1`` and ``w2`` are
    what the expert- and model-sharded cases shard."""

    def __init__(self, params):
        super().__init__()
        for k in sorted(params):
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(np.array(params[k]))))

    def loss(self, x, y):
        h = torch.tanh(x @ self.w1 + self.b1)
        return ((h @ self.w2 + self.b2 - y) ** 2).mean()


def _batch(inp, r, i):
    rows = slice(4 * r, 4 * r + 4)
    return (torch.from_numpy(inp["x"][i % len(inp["x"])][rows]),
            torch.from_numpy(inp["y"][i % len(inp["y"])][rows]))


def _set_guard(on, inject=""):
    """Install the guard (and a chaos spec) for this process, or take
    both away: a plain and a guarded run in one session."""
    os.environ["HOROVOD_GUARD_INJECT"] = inject
    cfg = Config.from_env()
    cfg.guard = on
    return guard.install(cfg, process_index=hvd.rank())


def _verdict():
    mon = guard.get()
    return None if mon is None or mon.last_verdict is None \
        else mon.last_verdict["action"]


# --------------------------------------------- repair: sharded leaves

def sharded_leaves(inp, keys_kind):
    """Two ranks, ``expert_keys`` over ep 2 (``keys_kind="expert"``) or
    ``model_keys`` over tp 2 (``"model"``), in the hooks' exchange: a
    ``nan`` spec poisons rank 0's bucket of the sharded leaf ``w2`` at
    step 1. Eagerly and through the compiled step: every rank's verdict
    by step, and the parameters; then healthy compiled runs, plain and
    guarded (the JAX package's
    test_moe_guard_program_identical_without_fault)."""
    hvd.init(device="cpu")
    r = hvd.rank()
    kw = ({"expert_keys": ("w2",)} if keys_kind == "expert"
          else {"model_keys": ("w2",)})
    out = {"rank": r}

    def build():
        model = _Net(inp["params"])
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05),
            named_parameters=model.named_parameters(),
            exchange_buckets=4, **kw)
        return model, opt

    for form in ("eager", "compiled"):
        model, opt = build()
        (b,) = [i for i, ps in enumerate(opt.exchange_buckets)
                if any(p is model.w2 for p in ps)]
        _set_guard(True, f"nan,name=grads.bucket{b},step=1,rank=0")
        step = hvd.compiled_train_step(model.loss, opt) \
            if form == "compiled" else None
        verdicts = []
        for i in range(3):
            x, y = _batch(inp, r, i)
            if step is None:
                opt.zero_grad()
                model.loss(x, y).backward()
                opt.step()
                verdicts.append(_verdict())
            else:
                step(x, y)
                if i:
                    verdicts.append(_verdict())
        if step is not None:
            verdicts.append(step.finish()["action"])
        out[f"{form}:verdicts"] = verdicts
        out[f"{form}:mode"] = opt._hvd_mode
        out[f"{form}:params"] = {k: v.detach().numpy().copy()
                                 for k, v in model.named_parameters()}
    for name, on in (("plain", False), ("guarded", True)):
        _set_guard(on)
        model, opt = build()
        step = hvd.compiled_train_step(model.loss, opt)
        for i in range(4):
            step(*_batch(inp, r, i))
        out[f"{name}:verdict"] = step.finish()
        out[name] = {k: v.detach().numpy().copy()
                     for k, v in model.named_parameters()}
    hvd.shutdown()
    return out


# ------------------------------------------------ the guard over ZeRO

def _gated(model, opt, resident):
    """Every tensor a skipped step must leave as it was: the parameters
    (but a resident stripe's, gathered anew each step), the stripe,
    the base optimizer's state and the DCN residual."""
    out = {}
    if not resident:
        out["params"] = [p.detach().numpy().copy()
                         for p in model.parameters()]
    owners = [opt.stripe] if opt.stripe is not None \
        else list(model.parameters())
    if opt.stripe is not None:
        out["stripe"] = opt.stripe.detach().numpy().copy()
    out["state"] = [{k: v.numpy().copy() for k, v in opt.state[p].items()}
                    for p in owners if p in opt.state]
    if opt._residual is not None:
        out["residual"] = opt._residual.numpy().copy()
    return out


def _final(model, step):
    if step is not None and step._resident:
        return [t.numpy().copy() for t in step.unshard_params()]
    return [p.detach().numpy().copy() for p in model.parameters()]


def _poison(model, r):
    """One NaN in rank 0's last gradient element only: after the
    scatter a single rank's stripe holds it."""
    if r == 0:
        with torch.no_grad():
            model.w2.grad.view(-1)[-1] = float("nan")


def zero_guard(inp, cases):
    """Four ranks (2 data x 2 expert where a case names expert keys):
    for each ``(name, kw, compiled)`` case, a plain and a guarded run of
    4 healthy Adam steps (the parameters, bitwise), a NaN step (the
    gated tensors before and after it, every rank's verdict), and three
    bad steps after a commit (the rollback: the gated tensors against
    the commit's, the residual zeroed)."""
    hvd.init(device="cpu")
    r = hvd.rank()
    out = {"rank": r}

    def build(kw, compiled, name):
        model = _Net(inp["params"])
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters(), **kw)
        step = hvd.compiled_train_step(model.loss, opt, name=name) \
            if compiled else None
        if step is not None and step._resident:
            step.shard_params()
        return model, opt, step

    def run(model, opt, step, i, bad=False):
        x, y = _batch(inp, r, i)
        if step is not None:
            return step(x, y)
        opt.zero_grad()
        model.loss(x, y).backward()
        if bad:
            _poison(model, r)
        opt.step()

    for name, kw, compiled in cases:
        tag = f"{name}:{'compiled' if compiled else 'eager'}"
        sname = f"zg.{tag}"
        for mode in ("plain", "guarded"):
            _set_guard(mode == "guarded")
            model, opt, step = build(kw, compiled, sname)
            for i in range(4):
                run(model, opt, step, i)
            if step is not None:
                out[f"{tag}:{mode}:verdict"] = step.finish()
                out[f"{tag}:sig"] = sorted(s[1] for s in step._signatures)
            out[f"{tag}:{mode}"] = _final(model, step)
        out[f"{tag}:exchange"] = opt._hvd_exchange

        # a NaN step: every gated tensor as it was
        _set_guard(True, f"nan,name={sname},step=2,rank=0"
                   if compiled else "")
        model, opt, step = build(kw, compiled, sname)
        resident = step is not None and step._resident
        verdicts = []
        for i in range(2):
            run(model, opt, step, i)
        before = _gated(model, opt, resident)
        run(model, opt, step, 2, bad=True)
        after = _gated(model, opt, resident)
        verdicts.append(step.finish()["action"] if step is not None
                        else _verdict())
        out[f"{tag}:nan"] = (before, after, verdicts)

        # three bad steps after a commit: the rollback
        mon = _set_guard(True, f"nan,name={sname},step=1,count=3,rank=0"
                         if compiled else "")
        model, opt, step = build(kw, compiled, sname)
        resident = step is not None and step._resident
        state = hvd.elastic.State(model=model, optimizer=opt)
        mon.attach_state(state)
        mon.attach_optimizer(opt)
        run(model, opt, step, 0)
        if step is not None:
            step.finish()
        state.commit()
        committed = _gated(model, opt, resident)
        actions = []
        for i in range(1, 4):
            run(model, opt, step, i, bad=True)
            if step is None:
                actions.append(_verdict())
            elif i > 1:
                actions.append(_verdict())
        if step is not None:
            actions.append(step.finish()["action"])
        out[f"{tag}:rollback"] = (committed, _gated(model, opt, resident),
                                  actions)
        out[f"{tag}:lr"] = opt.param_groups[0]["lr"]
    _set_guard(False)
    hvd.shutdown()
    return out


# ----------------------------------------------- the DCN chaos run

def dcn_chaos(inp):
    """tests/chaos_smoke.py's second run on this rank: the compiled
    ``zero_stage=2`` step with int8 DCN compression and every byte across
    the DCN hop (``dcn_local_size=1``); HOROVOD_GUARD_INJECT perturbs
    rank 1's parameters before step 2, the divergence probe
    (HOROVOD_GUARD_DIVERGENCE_INTERVAL=1) finds it on every rank, each
    rolls back to its last commit and zeroes the residual."""
    from horovod_tpu_torch import metrics
    hvd.init(device="cpu")
    me = hvd.rank()
    monitor = guard.get()
    assert monitor is not None, "HOROVOD_GUARD=1 expected"
    model = _Net(inp["params"])
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters(), zero_stage=2,
        dcn_compression="int8", dcn_local_size=1)
    step = hvd.compiled_train_step(model.loss, opt, name="chaos.dcn.step")
    state = hvd.elastic.State(model=model, optimizer=opt)
    state.commit()
    wire0 = metrics.WIRE_STAGE_BYTES.collect().get('stage="dcn"', 0.0)
    raw0 = metrics.WIRE_STAGE_RAW_BYTES.collect().get('stage="dcn"', 0.0)
    divergence_step = -1
    residual_committed = residual_after_reset = -1.0
    loss = float("nan")
    for i in range(5):
        loss = float(step(*_batch(inp, me, 0)))
        if monitor.check_divergence(model) is None:
            state.commit()
            continue
        divergence_step = i
        state.restore()
        residual_committed = float(opt._residual.abs().max())
        state.zero_residuals()
        residual_after_reset = float(opt._residual.abs().max())
        state.commit()
    step.finish()
    wire = metrics.WIRE_STAGE_BYTES.collect().get('stage="dcn"', 0.0) - wire0
    raw = metrics.WIRE_STAGE_RAW_BYTES.collect().get(
        'stage="dcn"', 0.0) - raw0
    out = {
        "rank": me,
        "w": [p.detach().numpy().copy() for p in model.parameters()],
        "loss": loss,
        "divergence_step": divergence_step,
        "divergence": metrics.GUARD_DIVERGENCE.value(),
        "repairs": metrics.GUARD_REPAIRS.value(),
        "inject_corrupt": metrics.GUARD_INJECTIONS.collect().get(
            'kind="corrupt"', 0.0),
        "residual_committed": residual_committed,
        "residual_after_reset": residual_after_reset,
        "fallback_steps": step.fallback_steps,
        "dcn_saved_frac": 1.0 - wire / max(raw, 1.0),
        "exchange": step._exchange,
    }
    hvd.shutdown()
    return out
