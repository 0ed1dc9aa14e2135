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
    assert all(p.requires_grad for p in lm.parameters())
    tokens = torch.from_numpy(_tokens())
    torch.testing.assert_close(lm(tokens), tfm.forward(again, tokens, tcfg),
                               rtol=0, atol=0)


@pytest.mark.parametrize("what", ["moe", "ulysses", "loss_chunk", "remat",
                                  "axes", "loss"])
def test_rejects_what_this_slice_does_not_carry(what):
    """MoE, Ulysses and tensor/expert axes raise. The loss, ``loss_chunk``
    and ``remat`` are carried now; over those axes they raise too
    (sequence parallelism is carried: tests/test_torch_ring_attention.py)."""
    if what in ("moe", "ulysses"):
        kw = {"moe": dict(moe_layers=(1,)),
              "ulysses": dict(sp_impl="ulysses")}[what]
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            _cfgs(**kw)
        return
    kw = {"loss_chunk": dict(loss_chunk=8), "remat": dict(remat=True)}
    _, tcfg = _cfgs(**kw.get(what, {}))
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if what == "axes":
            tfm.forward(params, tokens, tcfg, axes=tfm.ShardAxes(tp="tp"))
        else:
            tfm.loss_fn(params, tokens, tokens, tcfg,
                        axes=tfm.ShardAxes(ep="ep"))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(tcfg, torch.Generator().manual_seed(0))


# ----------------------------------------------------------- decoding
#
# init_cache / prefill_cache / decode_step / generate against the JAX
# package's, f32 at a tiny size: greedy tokens identical, logits within
# F32_ATOL (the serve tests' band for decode against the reference).


@pytest.mark.parametrize("positional,kv_heads,window,impl", [
    ("rope", None, None, "flash"), ("learned", 2, 6, "dense")])
def test_generate_greedy_matches_jax(positional, kv_heads, window, impl):
    jcfg, tcfg = _cfgs(positional=positional, n_kv_heads=kv_heads,
                       attention_window=window, attention_impl=impl,
                       max_seq=16)
    jparams, params = _pair(jcfg, tcfg)
    prompt = _tokens(b=2, s=5, seed=3)
    want = jax.jit(lambda p, t: jtfm.generate(p, t, jcfg, 7))(
        jparams, jnp.asarray(prompt))
    got = tfm.generate(params, torch.from_numpy(prompt), tcfg, 7)
    assert got.shape == (2, 12) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("positional,kv_heads", [("rope", 2),
                                                 ("learned", None)])
def test_decode_step_logits_match_jax(positional, kv_heads):
    jcfg, tcfg = _cfgs(positional=positional, n_kv_heads=kv_heads,
                       attention_impl="flash", max_seq=16)
    jparams, params = _pair(jcfg, tcfg)
    tokens = _tokens(b=2, s=10, seed=4)
    jprefill = jax.jit(jtfm.prefill_cache, static_argnums=3)
    jdecode = jax.jit(jtfm.decode_step, static_argnums=3)
    jcache = jtfm.init_cache(jcfg, 2, 12)
    logits, jcache = jprefill(jparams, jcache, jnp.asarray(tokens[:, :4]),
                              jcfg)
    want = [np.asarray(logits)]
    cache = tfm.init_cache(tcfg, 2, 12, device="cpu")
    logits, cache = tfm.prefill_cache(params, cache,
                                      torch.from_numpy(tokens[:, :4]), tcfg)
    got = [logits.numpy()]
    for i in range(4, 10):
        logits, jcache = jdecode(jparams, jcache, jnp.asarray(tokens[:, i]),
                                 jcfg)
        want.append(np.asarray(logits))
        logits, cache = tfm.decode_step(
            params, cache, torch.from_numpy(tokens[:, i]), tcfg)
        got.append(logits.numpy())
    assert int(cache["pos"]) == int(jcache["pos"]) == 10
    np.testing.assert_allclose(np.stack(got), np.stack(want),
                               atol=F32_ATOL, rtol=0)
    for lc, jlc in zip(cache["layers"], jcache["layers"]):
        np.testing.assert_allclose(lc["k"].numpy(), np.asarray(jlc["k"]),
                                   atol=F32_ATOL, rtol=0)


def test_generate_length_validation():
    _, tcfg = _cfgs(vocab_size=8, d_model=8, n_heads=2, n_layers=1, d_ff=8,
                    max_seq=8)
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="max_seq"):
        tfm.generate(params, torch.zeros((1, 6), dtype=torch.int64), tcfg, 4)


def test_generate_bad_args():
    _, tcfg = _cfgs(vocab_size=8, d_model=8, n_heads=2, n_layers=1, d_ff=8,
                    max_seq=16)
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.zeros((1, 6), dtype=torch.int64)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tfm.generate(params, prompt, tcfg, 0)
    with pytest.raises(ValueError, match="must cover"):
        tfm.generate(params, prompt, tcfg, 4, max_len=6)
    with pytest.raises(ValueError, match="temperature must be >= 0"):
        tfm.generate(params, prompt, tcfg, 4, temperature=-1.0)
    with pytest.raises(ValueError, match="needs a PRNG key"):
        tfm.generate(params, prompt, tcfg, 4, temperature=0.5)
    with pytest.raises(ValueError, match="top_k must be >= 1"):
        tfm.generate(params, prompt, tcfg, 4, top_k=0)


def test_prefill_warm_cache_rejected():
    """prefill on a non-fresh cache would clobber rows at offset 0 and
    ignore the context before them: it raises instead."""
    _, tcfg = _cfgs(max_seq=16)
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    cache = tfm.init_cache(tcfg, 1, 12, device="cpu")
    _, cache = tfm.decode_step(params, cache,
                               torch.zeros((1,), dtype=torch.int64), tcfg)
    with pytest.raises(ValueError, match="fresh cache"):
        tfm.prefill_cache(params, cache,
                          torch.zeros((1, 4), dtype=torch.int64), tcfg)


def test_generate_sampling_contract():
    """The port samples from a torch.Generator where the JAX package
    draws from jax.random, so the draws differ by design; what holds:
    top_k=1 is greedy, one seed gives one stream, every token is in the
    vocabulary."""
    _, tcfg = _cfgs(max_seq=16)
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.from_numpy(_tokens(b=2, s=4, seed=5))

    def sample(seed, **kw):
        return tfm.generate(params, prompt, tcfg, 8, temperature=0.8,
                            generator=torch.Generator().manual_seed(seed),
                            **kw)

    greedy = tfm.generate(params, prompt, tcfg, 8)
    assert torch.equal(sample(0, top_k=1), greedy)
    first = sample(1, top_k=5)
    assert torch.equal(first, sample(1, top_k=5))
    assert torch.equal(first[:, :4], prompt)
    assert bool(((first >= 0) & (first < tcfg.vocab_size)).all())


def test_generate_replays_one_decode_program_per_shape_in_a_session():
    """Under hvd.init() the decode program of a (B, max_len) lives in the
    session's program cache: a second generate of that shape hits it and
    gives the same tokens."""
    import horovod_tpu_torch as hvd
    _, tcfg = _cfgs(max_seq=16, attention_impl="flash")
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.from_numpy(_tokens(b=2, s=4, seed=6))
    alone = tfm.generate(params, prompt, tcfg, 6)
    hvd.init(device="cpu")
    try:
        programs = hvd.runtime.live_state().programs
        first = tfm.generate(params, prompt, tcfg, 6)
        second = tfm.generate(params, prompt, tcfg, 6)
        assert (programs.misses, programs.hits, len(programs)) == (1, 1, 1)
    finally:
        hvd.shutdown()
    assert torch.equal(first, alone) and torch.equal(second, alone)
