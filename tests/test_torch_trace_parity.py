"""Phase attribution of the compiled training step: the port's trace
against the JAX package's compiled step, on the CPU, for an MoE step and
for every ZeRO, guard and exchange layout.

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

Every layout of the compiled step, over 2 ranks: a 1-layer dense
transformer (d_model 32, f32) drawn from one numpy seed, one AdamW step
on the same 4 x 16 tokens (2 rows a rank), in each of psum at 1 and 2
buckets, ZeRO stages 1, 2 and 3, the staged DCN exchange (bf16, one
rank a host) and a stage-0 spec over (data 1, model 2) naming the FFN's
weights, each with the guard off and on. Each phase holds as many ops
of each kind on both sides: products (``dot`` against ``aten::mm`` /
``aten::bmm``), all-gathers, reduce-scatters and all-reduces (against
``c10d::_allgather_base_``, ``c10d::_reduce_scatter_base_``,
``c10d::allreduce_``) and the guard rows' finiteness tests
(``is-finite`` against ``aten::isfinite``; each row has one, and the
gate one over the rows).

The reference is read from its step's HLO as lowered, before XLA's
passes, where each traced op is one instruction under its op_name. The
optimized HLO, which the JAX trace reads, combines all-reduces: the
loss's ``pmean`` with the gradient row (one all-reduce at psum 1 and 2),
and at stage 3 under the guard the loss's with both of the row's psums,
the combined instruction landing in ``guard``; it also copies an
elementwise op into each fusion that reads it (17 ``is-finite`` for 10
rows). So counts are compared on the lowered HLO, and of the optimized
one each all-reduce must land in a phase where the lowered HLO has one
(or in ``exchange``, the loss's), its products as the lowered ones. An
all-reduce over groups of one device (a psum over the spec's data axis
of 1) moves nothing and is left out: the port issues no collective over
a group of one rank. The differences ``ROADMAP.md`` pins, held here:

- the port's step returns its rank's loss; the reference's ``pmean``
  of it (a scalar all-reduce in ``exchange``) is left out;
- ZeRO 1-2 and the staged DCN exchange run their exchange inside the
  reference's optimizer transform, under ``hvd_optimizer`` with no
  ``hvd_exchange`` label, though ``phase_of_op_name`` promises that such
  collectives count as ``exchange``; the port counts them there;
- at stages 1-3 the guard's row is one row over the averaged gradient
  stripe (10 over the updates, one a leaf, in the reference at stages
  1-2), its count and sum of squares summed over every rank in one
  all-reduce (the reference's update rows need none at stages 1-2 and
  psum each sum at stage 3); it lands in ``guard``, as all of the
  reference's rows there do.

On the parent the stage-3 gather landed outside every range (``None``)
and the guard's stripe rows, and the staged exchange's rows, in
``exchange``: ``zero3`` failed plain and guarded, ``zero1``, ``zero2``
and ``dcn`` guarded.
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
    and no device trace starts. ``lowered`` keeps the program's HLO as
    lowered, where a test wraps ``_analyze`` to take it."""

    text = None
    lowered = None

    def wants_hlo(self):
        return True

    def tick(self, owner=None, hlo=None):
        if hlo is not None:
            self.text = hlo() if callable(hlo) else hlo


def _jax_step_hlo(monkeypatch, loss_fn, tx, params, batch, mesh, name,
                  catcher=None):
    """The optimized HLO of one step of the JAX package's
    ``compiled_train_step`` over ``mesh``, run once (on the stripe, for
    the stripe-resident layout). The batch shards over every axis but
    ``model``, as the step's program takes it."""
    catcher = _HloCatcher() if catcher is None else catcher
    monkeypatch.setattr(jax_trace, "get", lambda: catcher)
    step = jhvd.compiled_train_step(loss_fn, tx, name=name)
    rep = NamedSharding(mesh, P())
    params = jax.device_put(params, rep)
    state = jax.device_put(step.init(params), rep)
    if step._resident:
        params = step.shard_params(params)
    data = NamedSharding(mesh, P(tuple(a for a in mesh.axis_names
                                       if a != "model")))
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


# ------------------------------------------ the compiled step's layouts
#
# A dense transformer over 2 ranks: the JAX package's compiled step over 2
# of the conftest's virtual devices (at one device XLA keeps no
# collective), the port's over 2 gloo ranks, the same weights, tokens and
# AdamW. Each layout runs with the guard off and on.

DENSE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=1, d_ff=64,
             max_seq=32)
DP, DP_ROWS = 2, 4
# {layout: (the JAX optimizer's kwargs, the port's, the JAX side's env)};
# the port's ranks run every layout under HOROVOD_MODEL_PARALLEL=2, which
# only the spec's optimizer reads.
LAYOUTS = {
    "psum1": ({}, {"exchange_buckets": 1}, {"HOROVOD_EXCHANGE_BUCKETS": "1"}),
    "psum2": ({}, {"exchange_buckets": 2}, {"HOROVOD_EXCHANGE_BUCKETS": "2"}),
    "zero1": ({"zero_stage": 1}, {"zero_stage": 1}, {}),
    "zero2": ({"zero_stage": 2}, {"zero_stage": 2}, {}),
    "zero3": ({"zero_stage": 3}, {"zero_stage": 3}, {}),
    "dcn": ({"dcn_compression": "bf16", "dcn_local_size": 1},
            {"dcn_compression": "bf16", "dcn_local_size": 1}, {}),
    "spec": ({"model_keys": ("['layers'][0]['w1']", "['layers'][0]['w2']")},
             {"model_keys": ("layers.0.w1", "layers.0.w2")},
             {"HOROVOD_MODEL_PARALLEL": "2"}),
}
# The layouts whose exchange the JAX package runs inside its optimizer
# transform, and those whose guard row is the port's one stripe row.
WHOLE_TRANSFORM = ("zero1", "zero2", "dcn")
STRIPED = ("zero1", "zero2", "zero3")
# what each side's op is a kind of
JAX_KINDS = {"dot": "product", "all-gather": "all-gather",
             "reduce-scatter": "reduce-scatter", "all-reduce": "all-reduce",
             "is-finite": "finite"}
PORT_KINDS = {"aten::mm": "product", "aten::bmm": "product",
              "c10d::_allgather_base_": "all-gather",
              "c10d::_reduce_scatter_base_": "reduce-scatter",
              "c10d::allreduce_": "all-reduce", "aten::isfinite": "finite"}

_LINE_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\S+)\s+"
                      r"([a-z][\w\-]*)\(")
_GROUPS_RE = re.compile(r"replica_groups=(\{[{}\d,]*\}|\[\d+,\d+\]<=)")


def _one_device_groups(line):
    """True for a collective whose groups each hold one device."""
    m = _GROUPS_RE.search(line)
    if m is None:
        return False
    groups = m.group(1)
    if groups.startswith("["):
        return groups.split(",")[1].startswith("1]")
    return all("," not in g for g in re.findall(r"\{([\d,]*)\}", groups))


def _jax_kinds(hlo):
    """``{(kind, phase): n}`` of an HLO text's instructions of the
    compared kinds, its phase by ``phase_of_op_name``. An all-reduce over
    groups of one device moves nothing and is left out, and so is the
    scalar all-reduce of ``exchange``, the loss's ``lax.pmean``."""
    phases = jax_trace.build_op_phase_map(hlo)
    out = collections.Counter()
    for line in hlo.splitlines():
        m = _LINE_RE.match(line)
        if m is None or m.group(3) not in JAX_KINDS:
            continue
        kind = JAX_KINDS[m.group(3)]
        phase = jax_trace.phase_of_op_name(phases.get(m.group(1)))
        if kind == "all-reduce" and (
                _one_device_groups(line)
                or (phase == "exchange" and m.group(2).endswith("[]"))):
            continue
        out[kind, phase] += 1
    return out


def _jax_layout(monkeypatch, layout, guarded):
    """``(lowered, optimized)`` HLO texts of the JAX package's compiled
    AdamW step of the dense transformer in ``layout`` over 2 devices."""
    from horovod_tpu.ops import step_program as jax_step
    jkw, _, env = LAYOUTS[layout]
    for k, v in dict(env, HOROVOD_GUARD="1" if guarded else "0").items():
        monkeypatch.setenv(k, v)
    catcher = _HloCatcher()
    analyze = jax_step.CompiledTrainStep._analyze

    def lowering(self, info, prog, params, opt_state, batch, tracer):
        catcher.lowered = prog.lower(params, opt_state, *batch).as_text(
            dialect="hlo", debug_info=True)
        return analyze(self, info, prog, params, opt_state, batch, tracer)

    monkeypatch.setattr(jax_step.CompiledTrainStep, "_analyze", lowering)
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **DENSE)
    tokens, targets = _dense_batch()
    jhvd.shutdown()
    jhvd.init(num_ranks=DP)
    try:
        mesh = jhvd.model_mesh() if layout == "spec" else jhvd.mesh()
        _jax_step_hlo(
            monkeypatch, lambda p, t, y: jtfm.loss_fn(p, t, y, jcfg),
            jhvd.DistributedOptimizer(optax.adamw(1e-3), **jkw),
            jax.tree.map(jnp.asarray, _jax_draw(jcfg, seed=0)),
            (tokens, targets), mesh, f"parity.{layout}.{int(guarded)}",
            catcher)
    finally:
        jhvd.shutdown()
    assert catcher.lowered
    return catcher.lowered, catcher.text


def _dense_batch():
    tokens = np.random.default_rng(1).integers(0, DENSE["vocab_size"],
                                               (DP_ROWS, 16))
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def port_layout_ops(tmp_path_factory):
    """Each gloo rank's ``{layout.guarded: {(op, phase): n}}`` of its
    traced step (``torch_rank_workers.step_phase_ops``)."""
    from torch_rank_workers import step_phase_ops
    from torch_ranks import spawn_ranks
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **DENSE)
    tokens, targets = _dense_batch()
    layouts = [(f"{name}.{int(g)}", kw, g)
               for name, (_, kw, _) in LAYOUTS.items() for g in (0, 1)]
    return spawn_ranks(
        DP, step_phase_ops, _jax_draw(jcfg, seed=0), DENSE, tokens,
        targets, layouts, tuple(PORT_KINDS),
        str(tmp_path_factory.mktemp("layout-trace")), timeout=180,
        env={"HOROVOD_MODEL_PARALLEL": "2"})


@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guard"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_layouts_land_in_the_reference_phases(
        layout, guarded, port_layout_ops, monkeypatch):
    """Every layout of the compiled step, guard off and on: each phase
    holds the reference's count of each kind of op, on every rank."""
    lowered, optimized = _jax_layout(monkeypatch, layout, guarded)
    ref = _jax_kinds(lowered)
    opt_kinds = _jax_kinds(optimized)
    # What the optimized HLO, which the JAX trace reads, combines: its
    # products are the lowered ones, and each all-reduce it keeps lands
    # in a phase where the lowered HLO has one.
    assert {k: n for k, n in opt_kinds.items() if k[0] == "product"} == \
        {k: n for k, n in ref.items() if k[0] == "product"}
    assert {ph for k, ph in opt_kinds if k == "all-reduce"} <= \
        {ph for k, ph in ref if k == "all-reduce"} | {"exchange"}
    want = collections.Counter(ref)
    if layout in WHOLE_TRANSFORM:
        # pinned: the reference's transform exchanges under hvd_optimizer
        for kind in ("all-gather", "reduce-scatter"):
            want[kind, "exchange"] += want.pop((kind, "optimizer"))
    if guarded and layout in STRIPED:
        # pinned: the reference's rows are its guard's work; the port's
        # is one row over the gradient stripe (the gate's is-finite
        # beside it), its two sums in one all-reduce over every rank
        assert {ph for k, ph in ref if k == "finite"} == {"guard"}
        assert {ph for k, ph in ref if k == "all-reduce"} <= {"guard"}
        want["finite", "guard"] = 2
        want["all-reduce", "guard"] = 1
    want = {k: n for k, n in want.items() if n}
    for rank, row in enumerate(port_layout_ops):
        got = collections.Counter()
        for (op, phase), n in row[f"{layout}.{int(guarded)}"].items():
            got[PORT_KINDS[op], phase] += n
        assert dict(got) == want, (rank, dict(got), want)
