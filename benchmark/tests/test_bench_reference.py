"""The plain reference against the program at tiny widths on the CPU.

In float32 throughout (the program's ``dtype`` set to float32, dense
attention) the two compute the same model and must agree to float32
round-off; at the configuration's own precision the program's first
steps must read within the cell's limits; and the reference's AdamW is
torch's."""

import json
import math

import pytest
import torch

from conftest import BENCH, TINY, make_tiny_root
from yardstick import cell, judge, spec, traffic, weights

REF = spec.load_module(BENCH / "reference" / "transformer_lm.py", "t_ref")


def tiny_cfg(name, **kw):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(TINY, **kw)
    if cfg["moe_layers"]:
        cfg.update(moe_layers=[1], moe_num_experts=4)
    return cfg


@pytest.mark.parametrize("name", ["flagship", "flagship-moe"])
def test_float32_loss_and_gradients_match_the_program(name):
    from horovod_tpu_torch.models import transformer as tfm
    torch.manual_seed(0)
    cfg = tiny_cfg(name)
    port = cell.port_config(tfm, dict(cfg, attention_impl="dense",
                                      precision=dict(cfg["precision"],
                                                     activations="float32")))
    tree, named = weights.make(cfg, seed=3, device="cpu")
    x, y = traffic.batches(dict(batches=1, batch=2, seq=64, zipf_s=1.0), 
                           cfg["vocab_size"], 3, 0, "cpu")
    leaves = {k: v.clone().requires_grad_() for k, v in named.items()}
    got = tfm.loss_fn(weights.tree(leaves, cfg), x[0], y[0], port)
    got_g = torch.autograd.grad(got, list(leaves.values()))
    REF.exact()
    ref_leaves = {k: v.clone().requires_grad_() for k, v in named.items()}
    want = REF.loss(weights.tree(ref_leaves, cfg), x[0], y[0], cfg)
    want_g = torch.autograd.grad(want, list(ref_leaves.values()))
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    for k, a, b in zip(leaves, got_g, want_g):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-7, k


def test_float32_moe_layer_matches_the_programs_plain_version():
    from horovod_tpu_torch.models import moe
    torch.manual_seed(1)
    cfg = tiny_cfg("flagship-moe")
    mcfg = moe.MoEConfig(d_model=cfg["d_model"], d_ff=cfg["d_ff"],
                         num_experts=4, top_k=2, dtype=torch.float32)
    p = moe.init_moe_params(mcfg, torch.Generator().manual_seed(2), "cpu")
    h = torch.randn(2, 64, cfg["d_model"])
    REF.exact()
    y_ref, aux_ref = REF.moe(h, p, cfg, "f32")
    y, aux = moe.moe_layer_reference(p, h, mcfg)
    assert torch.allclose(y, y_ref, rtol=1e-5, atol=1e-6)
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-6)


def test_adamw_is_torchs():
    torch.manual_seed(3)
    opt = dict(lr=3e-4, betas=[0.9, 0.999], eps=1e-8, weight_decay=1e-4)
    p = torch.randn(64)
    q = p.clone().requires_grad_()
    torch_opt = torch.optim.AdamW([q], lr=opt["lr"], betas=tuple(opt["betas"]),
                                  eps=opt["eps"],
                                  weight_decay=opt["weight_decay"])
    m, v = torch.zeros(64), torch.zeros(64)
    for t in range(1, 4):
        g = torch.randn(64)
        q.grad = g.clone()
        torch_opt.step()
        REF.adamw(p, g, m, v, t, opt)
    assert torch.allclose(p, q.detach(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("seed", [21, 22])
def test_the_programs_first_steps_read_within_the_limits(tmp_path, seed):
    """At the configuration's precision the dense cell's numbers hold at
    tiny widths too. (The MoE cell's do not there: at tiny widths a few
    routing flips move the median leaf as much as the full-size limits
    allow.)"""
    bench = spec.Bench(make_tiny_root(tmp_path))
    c = bench.cell("tiny-train")
    cfg, mix = bench.config(c["config"]), bench.traffic(c["traffic"])
    got = cell.readings(bench, "tiny-train", [seed], 0, "cpu")[0]["readings"]
    ref = cell.reference_readings(bench, cfg, mix, seed, 1, "cpu")
    values = judge.checks({k: [v] for k, v in got.items()}, ref)
    ok, shown = judge.verdict(values, bench.limits("tiny-train"))
    assert ok, shown
    assert all(math.isfinite(v[0]) for v in values.values())
