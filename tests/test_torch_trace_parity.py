"""Phase attribution of an MoE training step: the port's trace against
the JAX package's compiled step, on the CPU.

The JAX package maps each instruction of a step's optimized HLO to a
phase by its ``op_name`` (``build_op_phase_map``; the last ``hvd_``
label wins, ``phase_of_op_name``). JAX keeps a named scope in the name
of each transposed op (``hvd_backward/transpose(jvp(hvd_expert))/...``),
so the backward of the expert FFN counts as ``expert`` and the reverse
all-to-alls as ``dispatch`` and ``combine``. The port's tracer gives
each host op the phase of the ``hvd_`` ranges around it
(``diag/xla_trace.py``). Both must put the same work in each phase:

- One rank: a 2-layer MoE transformer (MoE in layer 1, E 4, top-2,
  d_model 64, f32, dense attention), its weights drawn from one numpy
  seed and carried to the port by ``params_from_jax``, one compiled
  AdamW step on the same tokens. Each phase holds as many matrix
  products on both sides: HLO ``dot`` instructions, ``aten::mm`` /
  ``aten::bmm`` ops. The JAX layer's dense one-hot dispatch and combine
  einsums (``tec,td->ecd``, ``tec,ecd->td``) are left out: the port
  computes them as gathers, with no product. Both sides keep them, the
  router and attention out of every MoE phase.
- An expert group of 2: the JAX layer over 2 of the conftest's virtual
  devices, the port over 2 gloo ranks, at chunks 1 and 2. ``dispatch``
  and ``combine`` each hold a forward and a reverse all-to-all a chunk
  (the tokens carry a gradient: the loss scales them by a learned
  vector), and ``expert`` the FFN's 6 products a chunk.

Before the port opened its MoE ranges around the backward, it put the
expert FFN's 4 backward products and every reverse all-to-all in
``backward``: at one rank ``expert`` held 2 products to the reference's
6 and ``backward`` 28 to 24; over the group ``dispatch`` and
``combine`` held 1 all-to-all to 2 at chunks 1 and 2 to 4 at chunks 2,
and ``expert`` 2 products to 6 (chunks 1) and 4 to 12 (chunks 2).
"""

import collections
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu.models.transformer as jtfm
import horovod_tpu_torch as hvd
from horovod_tpu.diag import xla_trace as jax_trace
from horovod_tpu.models import moe as jax_moe
from horovod_tpu_torch.diag import xla_trace
from horovod_tpu_torch.models import transformer as tfm
from torch_rank_workers import host_op_phases

MODEL = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=32, moe_layers=(1,), moe_num_experts=4, moe_top_k=2)
BATCH, SEQ = 2, 16
# A product's batch dimension tells its kind on the port's side:
# attention's is batch x heads, the experts' the expert count.
ATTENTION_BATCH = BATCH * MODEL["n_heads"]
E = MODEL["moe_num_experts"]
# The einsum equations in the JAX op names: the dense one-hot dispatch
# and combine (gathers in the port), the router, attention.
DENSE_ROUTING = ("tec,td->ecd", "tec,ecd->td")
ROUTER = ("td,de->te",)
ATTENTION = ("bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd")
PORT_PRODUCTS = ("aten::mm", "aten::bmm")
PORT_ALLTOALL = "c10d::alltoall_base_"
# The expert-group case: the MoE layer alone, as the MoE bench runs it.
EP, EP_D, EP_FF = 2, 16, 32
CHUNKS = (1, 2)

_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?\s([a-z][\w\-]*)\(")


class _HloCatcher:
    """Stands in for the JAX package's tracer: the compiled step hands
    it the optimized HLO of its program (``CompiledTrainStep._analyze``)
    and no device trace starts."""

    text = None

    def wants_hlo(self):
        return True

    def tick(self, owner=None, hlo=None):
        if hlo is not None:
            self.text = hlo() if callable(hlo) else hlo


def _jax_step_hlo(monkeypatch, loss_fn, tx, params, batch, mesh, name):
    """The optimized HLO of one step of the JAX package's
    ``compiled_train_step`` over ``mesh``, run once."""
    catcher = _HloCatcher()
    monkeypatch.setattr(jax_trace, "get", lambda: catcher)
    step = jhvd.compiled_train_step(loss_fn, tx, name=name)
    rep = NamedSharding(mesh, P())
    params = jax.device_put(params, rep)
    state = jax.device_put(step.init(params), rep)
    data = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    _, _, loss = step(params, state,
                      *(jax.device_put(b, data) for b in batch))
    assert catcher.text
    return catcher.text, float(loss)


def _jax_ops(hlo, opcode):
    """``[op_name]`` of the HLO's instructions of ``opcode``."""
    opcodes = {}
    for line in hlo.splitlines():
        m = _INSTR_RE.match(line)
        if m:
            opcodes[m.group(1)] = m.group(2)
    return [op for instr, op in jax_trace.build_op_phase_map(hlo).items()
            if opcodes.get(instr) == opcode]


def _equation(op_name):
    m = re.search(r"jvp\(([a-z,]+->[a-z]+)\)", op_name)
    return m.group(1) if m else None


def _jax_products(hlo):
    """{phase: dot instructions}, the dense routing einsums left out
    (and held outside every MoE phase)."""
    out = collections.Counter()
    for op in _jax_ops(hlo, "dot"):
        phase = jax_trace.phase_of_op_name(op)
        eq = _equation(op)
        if eq in DENSE_ROUTING + ROUTER + ATTENTION:
            assert phase in ("forward", "backward"), (op, phase)
        if eq not in DENSE_ROUTING:
            out[phase] += 1
    return dict(out)


def _jax_draw(jcfg, seed):
    """The JAX model's parameter tree drawn from one numpy seed: each
    leaf normal over the square root of its first dimension."""
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape, np.float32)
                                   / np.sqrt(s.shape[0])), shapes)


@pytest.fixture
def one_rank_jax():
    jhvd.shutdown()
    jhvd.init(num_ranks=1)
    try:
        yield jhvd.mesh()
    finally:
        jhvd.shutdown()


def test_moe_step_products_land_in_the_reference_phases(
        one_rank_jax, monkeypatch, tmp_path):
    """One rank: each phase holds the reference's count of matrix
    products, the expert FFN's backward in ``expert``; no router or
    attention product lands in a MoE phase."""
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **MODEL)
    tcfg = tfm.TransformerConfig(dtype=torch.float32, **MODEL)
    tree = _jax_draw(jcfg, seed=0)
    tokens = np.random.default_rng(1).integers(0, MODEL["vocab_size"],
                                               (BATCH, SEQ))
    targets = np.roll(tokens, -1, axis=1)
    hlo, jax_loss = _jax_step_hlo(
        monkeypatch, lambda p, t, y: jtfm.loss_fn(p, t, y, jcfg),
        jhvd.DistributedOptimizer(optax.adamw(1e-3)),
        jax.tree.map(jnp.asarray, tree), (tokens, targets), one_rank_jax,
        "parity.moe")
    want = _jax_products(hlo)
    assert want["expert"] == 6, want

    # the operands' shapes tell a product's kind
    monkeypatch.setattr(torch.profiler, "profile", functools.partial(
        torch.profiler.profile, record_shapes=True))
    hvd.init(device="cpu")
    try:
        lm = tfm.TransformerLM(tcfg, tfm.params_from_jax(tree, tcfg, "cpu"),
                               device="cpu")
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(lm.parameters(), lr=1e-3),
            named_parameters=lm.named_parameters())
        step = hvd.compiled_train_step(lm.loss, opt, name="parity.moe")
        t, y = torch.from_numpy(tokens), torch.from_numpy(targets)
        loss = step(t, y)
        tr = hvd.trace_steps(1, out_dir=str(tmp_path))
        for _ in range(2):
            step(t, y)
    finally:
        xla_trace.uninstall()
        hvd.shutdown()
    assert loss.item() == pytest.approx(jax_loss, abs=1e-5)
    got, kinds = collections.Counter(), collections.Counter()
    for ev, phase in host_op_phases(tr.last_dir, PORT_PRODUCTS):
        got[phase] += 1
        dims = ev["args"]["Input Dims"]
        kind = ("router" if ev["name"] == "aten::mm"
                else "attention" if dims[0][0] == ATTENTION_BATCH
                else "expert" if dims[0][0] == E else "other")
        kinds[kind, phase] += 1
    assert dict(got) == want, (dict(got), want)
    assert kinds["expert", "expert"] == 6 and not any(
        n for (kind, phase), n in kinds.items()
        if (kind == "expert") != (phase == "expert")), kinds
    assert tr.last_summary["phases"]["expert"] > 0


def _ep_inputs():
    rng = np.random.default_rng(2)
    d, ff = EP_D, EP_FF
    return {"w_router": rng.standard_normal((d, E), np.float32) / d ** 0.5,
            "w1": rng.standard_normal((E, d, ff), np.float32) / d ** 0.5,
            "w2": rng.standard_normal((E, ff, d), np.float32) / ff ** 0.5,
            "x": rng.standard_normal((EP, 2, 8, d), np.float32),
            "target": rng.standard_normal((EP, 2, 8, d), np.float32)}


@pytest.fixture(scope="module")
def port_ep_ops(tmp_path_factory):
    """Each gloo rank's ``{chunks: {(op, phase): n}}`` of its traced
    step (``torch_rank_workers.moe_phase_ops``)."""
    from torch_rank_workers import moe_phase_ops
    from torch_ranks import spawn_ranks
    return spawn_ranks(
        EP, moe_phase_ops, _ep_inputs(), dict(d_model=EP_D, d_ff=EP_FF,
                                               num_experts=E), CHUNKS,
        PORT_PRODUCTS + (PORT_ALLTOALL,),
        str(tmp_path_factory.mktemp("ep-trace")), timeout=120,
        env={"HOROVOD_EXPERT_PARALLEL": str(EP)})


@pytest.mark.parametrize("chunks", CHUNKS)
def test_moe_alltoalls_land_in_dispatch_and_combine(
        chunks, port_ep_ops, monkeypatch):
    """An expert group of 2: ``dispatch`` and ``combine`` each hold the
    forward and the reverse all-to-all of every chunk, as the reference
    counts them; the products land as the reference's too."""
    monkeypatch.setenv("HOROVOD_EXPERT_PARALLEL", str(EP))
    jhvd.shutdown()
    jhvd.init(num_ranks=EP)
    try:
        mesh = jhvd.expert_mesh()
        inp = _ep_inputs()
        cfg = jax_moe.MoEConfig(d_model=EP_D, d_ff=EP_FF, num_experts=E,
                                top_k=2, dtype=jnp.float32)
        e_loc = E // EP

        def shard(p):
            i = lax.axis_index("ep") * e_loc
            return {"w_router": p["w_router"],
                    "w1": lax.dynamic_slice_in_dim(p["w1"], i, e_loc, 0),
                    "w2": lax.dynamic_slice_in_dim(p["w2"], i, e_loc, 0),
                    "scale": jnp.ones((EP_D,), jnp.float32)}

        params = jax.jit(jax.shard_map(
            shard, mesh=mesh, in_specs=(P(),), out_specs=P(),
            check_vma=False))({k: jnp.asarray(inp[k])
                               for k in ("w_router", "w1", "w2")})

        def loss_fn(p, x, y):
            out, aux = jax_moe.moe_layer(
                {k: p[k] for k in ("w_router", "w1", "w2")}, x * p["scale"],
                cfg, ep_axis="ep", chunks=chunks)
            return jnp.mean((out - y) ** 2) + 0.01 * aux

        hlo, _ = _jax_step_hlo(
            monkeypatch, loss_fn,
            jhvd.DistributedOptimizer(optax.sgd(0.05),
                                      expert_keys=("w1", "w2")),
            params, (inp["x"].reshape(-1, 8, EP_D),
                     inp["target"].reshape(-1, 8, EP_D)), mesh,
            f"parity.ep{chunks}")
    finally:
        jhvd.shutdown()
    want_a2a = dict(collections.Counter(
        jax_trace.phase_of_op_name(op) for op in _jax_ops(hlo, "all-to-all")))
    want_dots = _jax_products(hlo)
    assert want_a2a == {"dispatch": 2 * chunks, "combine": 2 * chunks}
    for rank, row in enumerate(port_ep_ops):
        got = row[chunks]
        a2a = {ph: n for (op, ph), n in got.items() if op == PORT_ALLTOALL}
        dots = collections.Counter()
        for (op, ph), n in got.items():
            if op in PORT_PRODUCTS:
                dots[ph] += n
        assert a2a == want_a2a, (rank, a2a, want_a2a)
        assert dict(dots) == want_dots, (rank, dict(dots), want_dots)
