"""The port's transformer (horovod_tpu_torch/models/transformer.py)
against the JAX package's.

Parameters come from the JAX package's ``init_params``, pass through
``params_from_jax`` and feed both forwards with the same numpy tokens.
The JAX side runs ``attention_impl="flash"`` with the Pallas kernel in
interpret mode; the port's flash path computes the kernel's plain
version on the CPU.

Tolerances: f32 logits hold to atol 1e-4, the reference's band for its
flash model against dense (tests/test_flash_attention.py). bf16 logits
hold to atol 2e-2: activations are bf16, and one bf16 rounding that
lands the other way (2^-8 relative) in a hidden value moves a logit of
magnitude ~4 by about that much. Both packages mirror one another's
type promotions op for op, and on this model the observed gap against
the eager JAX forward is 0 in bf16 and below 2e-6 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.models.transformer as jtfm
from horovod_tpu_torch.models import transformer as tfm

F32_ATOL = 1e-4
BF16_ATOL = 2e-2


def _cfgs(dtype="float32", **kw):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=32)
    base.update(kw)
    jcfg = jtfm.TransformerConfig(dtype=getattr(jnp, dtype),
                                  flash_interpret=True, **base)
    return jcfg, tfm.TransformerConfig(dtype=getattr(torch, dtype), **base)


def _pair(jcfg, tcfg, seed=0):
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, tfm.params_from_jax(tree, tcfg, device="cpu")


def _jax_forward(jparams, tokens, jcfg):
    # Eager, not jitted: XLA fuses bf16 casts inside a jitted program, so
    # only the eager forward performs each rounding the source spells out
    # (the jitted one differs from it by up to ~2e-2 here in bf16).
    return np.asarray(jtfm.forward(jparams, jnp.asarray(tokens), jcfg))


def _tokens(b=2, s=16, vocab=64, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.mark.parametrize("positional,kv_heads", [("rope", None),
                                                 ("learned", 2)])
def test_params_from_jax_round_trip(positional, kv_heads):
    jcfg, tcfg = _cfgs(positional=positional, n_kv_heads=kv_heads)
    jparams, params = _pair(jcfg, tcfg)
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(leaves) == len(jax.tree.leaves(
        jax.tree.map(lambda t: 0, params)))
    for path, leaf in leaves:
        t = params
        for key in path:
            t = t[key.key if hasattr(key, "key") else key.idx]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_params_from_jax_rejects_mismatched_tree():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    missing = dict(tree, layers=[dict(tree["layers"][0]), tree["layers"][1]])
    del missing["layers"][0]["w2"]
    with pytest.raises(ValueError, match="keys"):
        tfm.params_from_jax(missing, tcfg, device="cpu")
    _, wide = _cfgs(d_ff=128)
    with pytest.raises(ValueError, match="shape"):
        tfm.params_from_jax(tree, wide, device="cpu")


@pytest.mark.parametrize("positional,kv_heads,dtype", [
    ("rope", None, "float32"),
    ("rope", 2, "float32"),
    ("learned", None, "float32"),
    ("learned", 2, "float32"),
    ("rope", 2, "bfloat16"),
    ("learned", None, "bfloat16"),
])
def test_forward_matches_jax_flash(positional, kv_heads, dtype):
    jcfg, tcfg = _cfgs(dtype, positional=positional, n_kv_heads=kv_heads,
                       attention_impl="flash")
    jparams, params = _pair(jcfg, tcfg)
    tokens = _tokens()
    want = _jax_forward(jparams, tokens, jcfg)
    got = tfm.forward(params, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_forward_window_matches_jax(impl):
    jcfg, tcfg = _cfgs(positional="rope", n_kv_heads=2, attention_window=5,
                       attention_impl=impl)
    jparams, params = _pair(jcfg, tcfg, seed=3)
    tokens = _tokens(seed=4)
    want = _jax_forward(jparams, tokens, jcfg)
    got = tfm.forward(params, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_transformer_lm_holds_params_and_runs_forward():
    _, tcfg = _cfgs(attention_impl="flash", positional="rope")
    lm = tfm.TransformerLM(tcfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    again = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = tfm.param_shapes(tcfg)
    assert {k: tuple(v.shape) for k, v in lm.params["layers"][1].items()} \
        == shapes["layers"][1]
    torch.testing.assert_close(lm.params["embed"], again["embed"], rtol=0,
                               atol=0)
    assert not any(p.requires_grad for p in lm.parameters())
    tokens = torch.from_numpy(_tokens())
    torch.testing.assert_close(lm(tokens), tfm.forward(again, tokens, tcfg),
                               rtol=0, atol=0)


@pytest.mark.parametrize("what", ["moe", "ulysses", "loss_chunk", "remat",
                                  "axes", "loss"])
def test_rejects_what_this_slice_does_not_carry(what):
    if what in ("moe", "ulysses", "loss_chunk", "remat"):
        kw = {"moe": dict(moe_layers=(1,)), "ulysses": dict(sp_impl="ulysses"),
              "loss_chunk": dict(loss_chunk=8), "remat": dict(remat=True)}[what]
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            _cfgs(**kw)
        return
    _, tcfg = _cfgs()
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if what == "axes":
            tfm.forward(params, tokens, tcfg, axes=object())
        else:
            tfm.loss_fn(params, tokens, tokens, tcfg)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(tcfg, torch.Generator().manual_seed(0))
