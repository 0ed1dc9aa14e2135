"""The port's eager torch surface (horovod_tpu_torch/__init__.py) against
the JAX package's torch binding (horovod_tpu/torch/__init__.py).

Two gloo ranks (one spawn for the module) run the autograd functions
(``HorovodAllreduce``, ``HorovodAllgather`` with uneven dim 0,
``HorovodBroadcast``), the in-place forms, fp16 compression, unnamed
ops, and ``DistributedOptimizer`` with a parameter whose
``requires_grad`` turns on after construction. The forward results are
held to the JAX binding's on the same per-rank inputs (``rank=r``
submissions over ``hvd.init(num_ranks=2)``), the gradients to its
autograd functions' (the cotangent is the same on every rank), and the
late parameter's training to plain torch on both ranks' batches. The
binding's one-rank behaviors (the op matrix, the optimizer's hooks,
clipping, forced exchanges, broadcasts) run in this process.

Behavioral spec: the 24 tests of tests/test_torch_binding.py.
"""

import warnings

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.torch as jt
import horovod_tpu_torch as hvd
from torch_engine_workers import binding_session
from torch_ranks import spawn_ranks

N = 2
STEPS = 3
RNG = np.random.default_rng(21)
INP = {"x": [RNG.integers(-8, 9, (4, 3)).astype(np.float32)
             for _ in range(N)],
       "w": RNG.standard_normal((4, 3)).astype(np.float32),
       "g": [RNG.integers(-8, 9, (2 + r, 3)).astype(np.float32)
             for r in range(N)],
       "gw": RNG.standard_normal((2 + 3, 3)).astype(np.float32),
       "w0": RNG.standard_normal((2, 3)).astype(np.float32),
       "b0": RNG.standard_normal(2).astype(np.float32),
       "opt_x": [[RNG.standard_normal((4, 3)).astype(np.float32)
                  for _ in range(N)] for _ in range(STEPS)]}


@pytest.fixture(scope="module")
def ranks():
    """Each rank's (autograd results, optimizer parameters by step)."""
    return spawn_ranks(N, binding_session, INP, STEPS)


@pytest.fixture(scope="module")
def reference():
    """The JAX binding's forward results for each rank's inputs, and its
    autograd gradients (the same cotangent on every rank)."""
    jhvd.shutdown()
    jhvd.init(num_ranks=N)
    try:
        out = {}
        for avg in (False, True):
            hs = [jt.allreduce_async(torch.from_numpy(INP["x"][r]),
                                     average=avg, name=f"ar.{avg}", rank=r)
                  for r in range(N)]
            out[f"ar_{avg}"] = [jt.synchronize(h).numpy() for h in hs]
            x = torch.from_numpy(INP["x"][0]).requires_grad_()
            y = jt.allreduce(x, average=avg, name=f"ar.grad.{avg}")
            (y * torch.from_numpy(INP["w"])).sum().backward()
            out[f"ar_{avg}_grad"] = x.grad.numpy()
        hs = [jt.allgather_async(torch.from_numpy(INP["g"][r]),
                                 name="gather", rank=r) for r in range(N)]
        out["gather"] = [jt.synchronize(h).numpy() for h in hs]
        hs = [jt.broadcast_async(torch.from_numpy(INP["x"][r]), 1,
                                 name="bcast", rank=r) for r in range(N)]
        out["bcast"] = [jt.synchronize(h).numpy() for h in hs]
        hs = [jt.broadcast_async(torch.from_numpy(INP["x"][r]), 0,
                                 name="bcast0", rank=r) for r in range(N)]
        out["bcast0"] = [jt.synchronize(h).numpy() for h in hs]
        hs = [jhvd.allreduce_async(INP["x"][r], name="fp16", rank=r,
                                   compression=jhvd.Compression.fp16)
              for r in range(N)]
        out["fp16"] = [jhvd.synchronize(h)[r] for r, h in enumerate(hs)]
    finally:
        jhvd.shutdown()
    return out


@pytest.mark.parametrize("average", [False, True])
def test_allreduce_forward_and_grad_match_the_reference(ranks, reference,
                                                        average):
    for r in range(N):
        y, grad = ranks[r][0][f"ar_{average}"]
        np.testing.assert_allclose(y, reference[f"ar_{average}"][r],
                                   rtol=1e-6)
        np.testing.assert_array_equal(grad,
                                      reference[f"ar_{average}_grad"])


def test_allgather_uneven_forward_and_grad(ranks, reference):
    """dim 0 of 2 and 3: the gradient is the summed cotangent narrowed to
    each rank's rows (torch/mpi_ops.py:236-254)."""
    for r in range(N):
        y, grad = ranks[r][0]["gather"]
        np.testing.assert_array_equal(y, reference["gather"][r])
        off = sum(2 + q for q in range(r))
        np.testing.assert_allclose(grad, N * INP["gw"][off:off + 2 + r],
                                   rtol=1e-6)


def test_broadcast_forward_and_grad(ranks, reference):
    """The root gets every rank's cotangent, the others zero
    (torch/mpi_ops.py:322-337)."""
    for r in range(N):
        y, grad = ranks[r][0]["bcast"]
        np.testing.assert_array_equal(y, reference["bcast"][r])
        want = N * INP["w"] if r == 1 else np.zeros_like(INP["w"])
        np.testing.assert_allclose(grad, want, rtol=1e-6)


def test_inplace_forms_write_into_the_input(ranks, reference):
    for r in range(N):
        same, value = ranks[r][0]["inplace"]
        assert same
        np.testing.assert_allclose(value, reference["ar_True"][r],
                                   rtol=1e-6)
        np.testing.assert_array_equal(ranks[r][0]["bcast_inplace"],
                                      reference["bcast0"][r])


def test_fp16_compression_matches_the_reference(ranks, reference):
    for r in range(N):
        np.testing.assert_array_equal(ranks[r][0]["fp16"],
                                      reference["fp16"][r])


def test_unnamed_ops_negotiate_across_ranks(ranks):
    for r in range(N):
        np.testing.assert_array_equal(ranks[r][0]["noname"],
                                      np.full(2, float(N)))


def test_late_requires_grad_trains_like_plain_torch(ranks):
    """The bias, frozen at construction and unfrozen after the first
    step, joins the exchange at the next step (the reference's
    test_dynamic_requires_grad): both ranks hold plain torch's parameters
    on the mean of both ranks' losses."""
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(INP["w0"]))
        model.bias.copy_(torch.from_numpy(INP["b0"]))
    model.bias.requires_grad_(False)
    opt = torch.optim.SGD([model.weight, model.bias], lr=0.1)
    for s in range(STEPS):
        if s == 1:
            model.bias.requires_grad_(True)
        loss = sum((model(torch.from_numpy(INP["opt_x"][s][r])) ** 2).mean()
                   for r in range(N)) / N
        opt.zero_grad()
        loss.backward()
        opt.step()
        for r in range(N):
            w, b, has_grad = ranks[r][1][s]
            np.testing.assert_allclose(w, model.weight.detach().numpy(),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(b, model.bias.detach().numpy(),
                                       rtol=1e-5, atol=1e-6)
            assert has_grad == (s >= 1)
    assert not np.array_equal(ranks[0][1][0][1], ranks[0][1][-1][1])


# ------------------------------------------------------------- one rank

@pytest.fixture
def one():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_allreduce(one):
    out = hvd.allreduce(torch.ones(4, 3) * 2, name="t.ar")
    assert torch.equal(out, torch.ones(4, 3) * 2)


def test_allreduce_async_per_rank(one):
    h = hvd.allreduce_async(torch.full((3,), 5.0), average=False,
                            name="t.ar.rank", rank=0)
    assert torch.equal(hvd.synchronize(h), torch.full((3,), 5.0))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64, torch.int32, torch.int64,
                                   torch.bfloat16])
def test_allreduce_dtypes(one, dtype):
    t = torch.arange(6).to(dtype)
    out = hvd.allreduce(t, average=False, name=f"t.dt.{dtype}")
    assert out.dtype == dtype and torch.equal(out, t)


def test_allgather_and_broadcast_inplace(one):
    out = hvd.allgather(torch.full((2, 2), 3.0), name="t.ag")
    assert out.shape == (2, 2)
    t = torch.arange(3.0)
    assert hvd.broadcast_(t, root_rank=0, name="t.bc.in") is t


def test_fp16_compression_round_trip(one):
    x = torch.full((8,), 1.25) + torch.arange(8) * 1e-4
    out = hvd.allreduce(x, name="t.fp16", compression=hvd.Compression.fp16)
    assert out.dtype == torch.float32
    assert torch.equal(out, x.half().float())


def test_grads_of_the_autograd_functions(one):
    x = torch.ones(4, 3, requires_grad=True)
    hvd.allreduce(x, average=False, name="g.ar").backward(torch.ones(4, 3))
    assert torch.equal(x.grad, torch.full((4, 3), float(hvd.size())))
    g = torch.ones(2, 3, requires_grad=True)
    y = hvd.allgather(g, name="g.ag")
    y.backward(torch.ones(2 * hvd.size(), 3))
    assert torch.equal(g.grad, torch.full((2, 3), float(hvd.size())))
    b = torch.ones(3, requires_grad=True)
    hvd.broadcast(b, 0, name="g.bc").backward(torch.ones(3))
    assert torch.equal(b.grad, torch.full((3,), float(hvd.size())))


def _model_and_opt(bpps=1):
    model = torch.nn.Linear(4, 2)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=bpps)
    return model, opt


def test_optimizer_step_synchronize_warns_and_accumulates(one):
    model, opt = _model_and_opt()
    x, y = torch.randn(8, 4), torch.randn(8, 2)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    opt.zero_grad()
    torch.nn.functional.mse_loss(model(x), y).backward()
    opt.synchronize()
    torch.nn.utils.clip_grad_norm_(model.parameters(), 0.01)
    with pytest.warns(UserWarning, match="called after"):
        opt.step()
    model, opt = _model_and_opt(bpps=2)
    opt.zero_grad()
    torch.nn.functional.mse_loss(model(x), y).backward()
    torch.nn.functional.mse_loss(model(x), y).backward()
    opt.step()
    opt.zero_grad()
    torch.nn.functional.mse_loss(model(x), y).backward()
    torch.nn.functional.mse_loss(model(x), y).backward()
    with pytest.raises(AssertionError, match="backward_passes_per_step"):
        torch.nn.functional.mse_loss(model(x), y).backward()


def test_gradient_clipping_then_step_without_synchronize(one):
    model, opt = _model_and_opt()
    loss = torch.nn.functional.mse_loss(model(torch.ones(1, 4)),
                                        torch.full((1, 2), 40.0))
    opt.zero_grad()
    loss.backward()
    opt.synchronize()
    prior = float(model.weight.grad.norm())
    torch.nn.utils.clip_grad_norm_(model.parameters(), 0.1)
    assert float(model.weight.grad.norm()) < prior
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        opt.step(synchronize=False)


def test_unused_and_untouched_parameters_are_forced(one):
    """Parameters outside the loss still exchange: a kept zero grad, and
    a grad that was never made materialized as zeros."""
    fc1, fc2, unused = (torch.nn.Linear(4, 4) for _ in range(3))
    params = [*fc1.parameters(), *fc2.parameters(), *unused.parameters()]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.1),
        named_parameters=[(f"p{i}", p) for i, p in enumerate(params)])
    x = torch.randn(2, 4)
    opt.zero_grad()
    (fc2(fc1(x)) ** 2).mean().backward()
    opt.step()
    opt.zero_grad(set_to_none=False)
    (fc1(x) ** 2).mean().backward()
    opt.step()
    for p in [*fc2.parameters(), *unused.parameters()]:
        assert p.grad is not None and float(p.grad.abs().sum()) == 0.0


def test_named_parameters_checks(one):
    model = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="must be unique"):
        hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=[("w", model.weight), ("w", model.bias)])
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    (model(torch.randn(3, 2)) ** 2).mean().backward()
    opt.step()
    assert all(p.grad is not None for p in model.parameters())


def test_broadcasts_of_parameters_and_optimizer_state(one):
    model = torch.nn.Linear(3, 3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    opt = torch.optim.SGD(model.parameters(), lr=0.25, momentum=0.5)
    model(torch.randn(2, 3)).sum().backward()
    opt.step()
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    assert opt.param_groups[0]["lr"] == 0.25
    assert isinstance(opt.param_groups[0]["lr"], float)
