"""The port's training path against the JAX package's: ``loss_fn`` and
its gradients, and AdamW steps.

Parameters come from the port's ``init_params`` (a seeded
``torch.Generator``) and reach JAX as numpy arrays
(``params_to_numpy``); tokens come from numpy. The JAX side takes
``jax.value_and_grad(tfm.loss_fn)`` with ``attention_impl="flash"`` and
the Pallas kernels in interpret mode (jitted: the interpreter is slow
eagerly); the port's flash path runs the plain versions of its kernels
through the autograd ``Function`` on the CPU.

Tolerances:
- f32: the loss to 1e-5 and every gradient leaf to atol 1e-5. Both
  packages take the same f32 products in another summation order; the
  observed gap is below 1e-6.
- bf16: the loss to 1e-2 and each gradient leaf by relative L2
  difference ``|g - g_ref| / |g_ref|`` at most 2e-2. The weight
  gradients are rounded to bf16 by the casts on both sides, and the
  jitted JAX program fuses some bf16 roundings the eager port performs,
  which moves values by about one bf16 rounding (2^-8).
- AdamW against ``optax.adamw(lr, weight_decay=1e-4)`` over five steps:
  parameters to atol 2e-6 after each step. Both apply
  ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` from the old p,
  with the bias corrections rounded in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu.models.transformer as jtfm
from horovod_tpu_torch.models import transformer as tfm

LR = 1e-3
WD = 1e-4
F32_ATOL = 1e-5
BF16_LOSS_ATOL = 1e-2
BF16_REL_L2 = 2e-2
ADAM_ATOL = 2e-6


def _cfgs(dtype="float32", **kw):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=32, attention_impl="flash")
    base.update(kw)
    jcfg = jtfm.TransformerConfig(dtype=getattr(jnp, dtype),
                                  flash_interpret=True, **base)
    return jcfg, tfm.TransformerConfig(dtype=getattr(torch, dtype), **base)


def _pair(tcfg, seed):
    """(JAX parameter tree, the port's parameters), equal leaf for
    leaf."""
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(seed),
                             "cpu")
    return jax.tree.map(jnp.asarray, tfm.params_to_numpy(params)), params


def _batch(b=2, s=16, vocab=64, seed=1):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return tokens, np.roll(tokens, -1, axis=1)


def _flat(tree):
    """{path: leaf} of a params tree (dicts and the layers list)."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            for i, layer in enumerate(v):
                out.update({f"layers.{i}.{n}": x for n, x in layer.items()})
        else:
            out[k] = v
    return out


def _jax_loss_and_grads(jparams, tokens, targets, jcfg):
    fn = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jnp.asarray(tokens), jnp.asarray(targets),
                               jcfg)))
    loss, grads = fn(jparams)
    return float(loss), {k: np.asarray(v, np.float32)
                         for k, v in _flat(grads).items()}


def _port_loss_and_grads(params, tokens, targets, tcfg):
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_()
    loss = tfm.loss_fn(params, torch.from_numpy(tokens),
                       torch.from_numpy(targets), tcfg)
    loss.backward()
    return float(loss.detach()), {k: t.grad.numpy()
                                  for k, t in leaves.items()}


@pytest.mark.parametrize("positional,kv_heads,loss_chunk,remat,dtype", [
    ("rope", 2, None, False, "float32"),
    ("learned", None, 8, True, "float32"),
    ("rope", None, 4, False, "float32"),
    ("learned", 2, None, True, "float32"),
    ("rope", 2, 8, True, "bfloat16"),
    ("learned", None, None, False, "bfloat16"),
])
def test_loss_and_gradients_match_jax(positional, kv_heads, loss_chunk,
                                      remat, dtype):
    jcfg, tcfg = _cfgs(dtype, positional=positional, n_kv_heads=kv_heads,
                       loss_chunk=loss_chunk, remat=remat)
    jparams, params = _pair(tcfg, seed=0)
    tokens, targets = _batch()
    want_loss, want = _jax_loss_and_grads(jparams, tokens, targets, jcfg)
    got_loss, got = _port_loss_and_grads(params, tokens, targets, tcfg)
    assert set(got) == set(want)
    if dtype == "float32":
        assert abs(got_loss - want_loss) <= F32_ATOL
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=F32_ATOL,
                                       rtol=0, err_msg=k)
        return
    assert abs(got_loss - want_loss) <= BF16_LOSS_ATOL
    for k in want:
        rel = np.linalg.norm(got[k] - want[k]) / max(
            np.linalg.norm(want[k]), 1e-30)
        assert rel <= BF16_REL_L2, (k, rel)


def test_loss_chunk_must_divide_the_sequence():
    _, tcfg = _cfgs(loss_chunk=5)
    params = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens, targets = _batch()
    with pytest.raises(ValueError, match=r"loss_chunk \(5\) must divide the "
                                         r"per-shard sequence length \(16\); "
                                         r"pick a divisor \(e.g. 1\)"):
        tfm.loss_fn(params, torch.from_numpy(tokens),
                    torch.from_numpy(targets), tcfg)


def test_out_of_range_targets_are_masked_as_in_jax():
    jcfg, tcfg = _cfgs(positional="rope")
    jparams, params = _pair(tcfg, seed=2)
    tokens, targets = _batch(seed=3)
    targets[0, :3] = [-1, 64, 1000]
    want_loss, _ = _jax_loss_and_grads(jparams, tokens, targets, jcfg)
    got = tfm.loss_fn(params, torch.from_numpy(tokens),
                      torch.from_numpy(targets), tcfg)
    assert abs(float(got) - want_loss) <= F32_ATOL


def test_adamw_steps_track_optax():
    jcfg, tcfg = _cfgs(positional="rope", n_kv_heads=2, loss_chunk=8)
    jparams, params = _pair(tcfg, seed=4)
    lm = tfm.TransformerLM(tcfg, params, device="cpu")
    tokens, targets = _batch(seed=5)
    tx = optax.adamw(LR, weight_decay=WD)

    @jax.jit
    def step(p, state):
        g = jax.grad(lambda q: jtfm.loss_fn(q, jnp.asarray(tokens),
                                            jnp.asarray(targets), jcfg))(p)
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    opt = torch.optim.AdamW(lm.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=WD)
    state = tx.init(jparams)
    for i in range(5):
        jparams, state = step(jparams, state)
        opt.zero_grad()
        lm.loss(torch.from_numpy(tokens), torch.from_numpy(targets)).backward()
        opt.step()
        want = {k: np.asarray(v) for k, v in _flat(jparams).items()}
        got = _flat(tfm.params_to_numpy(lm.params))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=ADAM_ATOL,
                                       rtol=0, err_msg=f"step {i}: {k}")


def test_params_to_numpy_inverts_params_from_jax():
    _, tcfg = _cfgs(positional="learned", n_kv_heads=2)
    rng = np.random.default_rng(6)
    shapes = tfm.param_shapes(tcfg)
    tree = {k: rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items() if k != "layers"}
    tree["layers"] = [{k: rng.standard_normal(v).astype(np.float32)
                       for k, v in layer.items()}
                      for layer in shapes["layers"]]
    back = tfm.params_to_numpy(tfm.params_from_jax(tree, tcfg, device="cpu"))
    assert set(_flat(back)) == set(_flat(tree))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(back)[k], v)
