"""The port's captured programs (ops/step_program.py) on the card: the
compiled training step, the serve engine's per-bin graphs and
``generate``'s decode graph against the same code run eagerly.

Every test here needs an NVIDIA card and skips without one. The module
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; there, skip tests/conftest.py (which sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

A replay runs the kernels its capture recorded, on the same static
buffers, so it is held to the eager run bitwise: parameters after
several steps on new batches, serving logits across a ``defrag``, and
greedy tokens. The eager side turns capture off with
``HOROVOD_STEP_PROGRAM=0`` and keeps the same kernels and optimizer.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.cuda

# head_dim 64, bf16: the flash kernels take their tensor-core route
SMALL = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=512, max_seq=256, positional="rope",
             attention_impl="flash", dtype=torch.bfloat16)
ADAMW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
# an MoE layer (E 4, top-2) in place of the second dense FFN
MOE_SMALL = dict(SMALL, moe_layers=(1,), moe_num_experts=4, moe_top_k=2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs do not run on the "
                    "CPU")
    hvd.init(device="cuda")
    yield hvd.runtime.device()
    hvd.shutdown()


def _train(card, compiled, batches, model=SMALL, axes=None, **kw):
    cfg = tfm.TransformerConfig(loss_chunk=64, **model)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card, axes=axes)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
        named_parameters=lm.named_parameters(), **kw)
    step = hvd.compiled_train_step(lm.loss, opt) if compiled else None
    for tokens, targets in batches:
        if compiled:
            step(tokens, targets)
        else:
            opt.zero_grad(set_to_none=True)
            lm.loss(tokens, targets).backward()
            opt.step()
    torch.cuda.synchronize()
    return lm, step


def _batches(card, n, b=2, s=128):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        t = rng.integers(0, SMALL["vocab_size"], (b, s))
        out.append((torch.from_numpy(t).to(card),
                    torch.from_numpy(np.roll(t, -1, axis=1)).to(card)))
    return out


def test_captured_step_replayed_on_new_batches_equals_eager(card):
    batches = _batches(card, 4)
    eager, _ = _train(card, False, batches)
    compiled, step = _train(card, True, batches)
    assert (step.cache_misses, step.cache_hits, step.fallback_steps) == (
        1, 3, 0)
    for (name, a), (_, b) in zip(eager.named_parameters(),
                                 compiled.named_parameters()):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_sp_step_replayed_on_new_batches_equals_eager(card, sp_impl):
    """A sequence-parallel step over a local axis of 2, captured: the
    ring (window 48 over shards of 64, so every layer runs a band tile)
    and Ulysses (H 2 / H_kv 1 a shard). Parameters after 4 steps bitwise
    equal to the eager run's; a replay runs the kernels its capture
    recorded (per layer, 2 of each static kernel, and the ring's 1 of
    each band kernel)."""
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    batches = _batches(card, 4)
    model = dict(SMALL, sp_impl=sp_impl, attention_window=48)
    axes = tfm.ShardAxes(sp=RingAxis.local(2))
    eager, _ = _train(card, False, batches, model=model, axes=axes)
    n0 = fa.launch_counts()
    compiled, step = _train(card, True, batches, model=model, axes=axes)
    got = {k: v - n0[k] for k, v in fa.launch_counts().items()
           if v != n0[k]}
    assert (step.cache_misses, step.cache_hits, step.fallback_steps) == (
        1, 3, 0)
    layers, band = SMALL["n_layers"], int(sp_impl == "ring")
    want = {"wgmma_launches": 2, "dq_wgmma_launches": 2,
            "dkv_wgmma_launches": 2, "band_wgmma_launches": band,
            "band_dq_wgmma_launches": band,
            "band_dkv_wgmma_launches": band}
    assert got == {k: 4 * layers * n for k, n in want.items() if n}
    for (name, a), (_, b) in zip(eager.named_parameters(),
                                 compiled.named_parameters()):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


def test_moe_step_replayed_on_new_batches_equals_eager(card):
    """The MoE layer's routing tables, gather dispatch and combine, its
    expert products and the expert-keyed exchange, captured: parameters
    after 4 steps bitwise equal to the eager run's."""
    batches = _batches(card, 4)
    keys = dict(expert_keys=("moe.w1", "moe.w2"))
    eager, _ = _train(card, False, batches, model=MOE_SMALL, **keys)
    compiled, step = _train(card, True, batches, model=MOE_SMALL, **keys)
    assert step._exchange == "moe"
    assert (step.cache_misses, step.cache_hits, step.fallback_steps) == (
        1, 3, 0)
    for (name, a), (_, b) in zip(eager.named_parameters(),
                                 compiled.named_parameters()):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_step_replayed_on_new_batches_equals_eager(card, stage,
                                                        monkeypatch):
    """The ZeRO ladder captured (256 KiB chunks at stages 2 and 3, so the
    capture takes several reduce-scatters and all-gathers): parameters
    after 4 steps bitwise equal to the same stage's eager run and to
    stage 0's (one rank: the scatter and gather are copies), zero3's read
    back through ``unshard_params``; one reduce-scatter and one
    all-gather record a chunk a replay."""
    monkeypatch.setenv("HOROVOD_PROFILER_JIT_CALLBACKS", "1")
    batches = _batches(card, 4)
    kw = dict(zero_stage=stage, bucket_bytes=None if stage == 1 else 2 ** 18)
    eager, _ = _train(card, False, batches, **kw)
    stage0, _ = _train(card, True, batches)
    compiled, step = _train(card, True, batches, **kw)
    assert step._exchange == f"zero{stage}"
    assert (step.cache_misses, step.cache_hits, step.fallback_steps) == (
        1, 3, 0)
    got = (step.unshard_params() if stage == 3
           else [p.detach() for p in compiled.parameters()])
    for (name, a), b, c in zip(eager.named_parameters(), got,
                               stage0.parameters()):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))
        assert torch.equal(a, c), (name, float((a - c).abs().max()))
    prog = list(hvd.runtime.live_state().programs._programs.values())[-1]
    chunks = len(step._optimizer.exchange_buckets)
    assert (chunks > 1) == (stage > 1)
    ops = [op for op, _ in prog.collectives]
    assert sorted(ops) == ["allgather_jit"] * chunks + \
        ["reducescatter_jit"] * chunks


def test_zero3_round_trip_is_exact(card):
    lm = tfm.TransformerLM(tfm.TransformerConfig(loss_chunk=64, **SMALL),
                           generator=torch.Generator().manual_seed(0),
                           device=card)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
        named_parameters=lm.named_parameters(), zero_stage=3)
    step = hvd.compiled_train_step(lm.loss, opt)
    want = [p.detach().clone() for p in lm.parameters()]
    for a, b in zip(want, step.unshard_params(step.shard_params())):
        assert torch.equal(a, b)


def test_moe_serve_graphs_equal_eager(card, monkeypatch):
    """The MoE model served at full capacity through the per-bin graphs
    gives the eager engine's logits, across a defrag."""
    graphs, got = _serve(card, monkeypatch, True, model=MOE_SMALL)
    _, want = _serve(card, monkeypatch, False, model=MOE_SMALL)
    assert graphs.decode_misses == 1 and graphs.moe_full_capacity
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_replay_counts_the_launches_and_exchanges_it_runs(card,
                                                          monkeypatch):
    monkeypatch.setenv("HOROVOD_PROFILER_JIT_CALLBACKS", "1")
    batches = _batches(card, 1)
    _, step = _train(card, True, batches, exchange_buckets=2)
    prog = next(iter(hvd.runtime.live_state().programs._programs.values()))
    layers = SMALL["n_layers"]
    assert prog.launches == {"wgmma_launches": layers,
                             "dq_wgmma_launches": layers,
                             "dkv_wgmma_launches": layers}
    assert [op for op, _ in prog.collectives] == ["allreduce_jit"] * 2
    stats = hvd.runtime.live_state().stats
    jit0 = stats.counter("allreduce_jit")
    before = fa.launch_counts()
    for _ in range(3):
        step(*batches[0])
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {c: after[c] - before[c] for c in after
            if after[c] != before[c]} == {c: 3 * n
                                          for c, n in prog.launches.items()}
    assert stats.counter("allreduce_jit") - jit0 == 6


def _serve(card, monkeypatch, capture, model=SMALL):
    monkeypatch.setenv("HOROVOD_STEP_PROGRAM", "1" if capture else "0")
    cfg = tfm.TransformerConfig(**model)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(1), card)
    # batch_bin_floor 4: the 3 rows before the defrag and the 2 after it
    # share one decode bin, so its graph replays across the defrag
    eng = ServeEngine(params, cfg, num_pages=32, page_size=16,
                      batch_bin_floor=4, page_bin_floor=4, len_bin_floor=32,
                      device=card)
    for sid in (0, 1, 2):
        eng.cache.allocate(sid, 64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, 20).tolist() for _ in range(3)]
    rows = [eng.prefill([0, 1, 2], prompts)]
    tokens, lengths = [p[-1] for p in prompts], [20, 20, 20]
    for i in range(3):
        rows.append(eng.decode([0, 1, 2], tokens, [n + i for n in lengths]))
    eng.cache.free(1)
    assert eng.defrag() > 0
    for i in range(3, 8):
        rows.append(eng.decode([0, 2], tokens[::2],
                               [n + i for n in lengths[::2]]))
    return eng, rows


def test_decode_graph_stays_right_across_defrag(card, monkeypatch):
    graphs, got = _serve(card, monkeypatch, capture=True)
    _, want = _serve(card, monkeypatch, capture=False)
    assert graphs.decode_misses == 1 and graphs.decode_hits == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_generate_replays_a_decode_graph_with_eager_tokens(card,
                                                           monkeypatch):
    cfg = tfm.TransformerConfig(**SMALL)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(2), card)
    prompt = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (2, 40))).to(card)
    graphs = tfm.generate(params, prompt, cfg, 24)
    programs = hvd.runtime.live_state().programs
    assert (programs.misses, len(programs)) == (1, 1)
    programs.clear()
    monkeypatch.setenv("HOROVOD_STEP_PROGRAM", "0")
    eager = tfm.generate(params, prompt, cfg, 24)
    assert torch.equal(graphs, eager)


def test_a_dropped_step_frees_its_graph_and_model(card):
    """The program cache holds a compiled step weakly: once the caller
    drops the step, its model and its optimizer, the graph leaves the
    cache and nothing holds the model's parameters or the optimizer's
    state on the card any more."""
    import gc
    import weakref
    cfg = tfm.TransformerConfig(loss_chunk=64, **SMALL)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
        named_parameters=lm.named_parameters())
    step = hvd.compiled_train_step(lm.loss, opt)
    for tokens, targets in _batches(card, 3):
        step(tokens, targets)
    programs = hvd.runtime.live_state().programs
    assert len(programs) == 1
    held = [weakref.ref(lm), weakref.ref(opt), weakref.ref(lm.params["embed"]),
            *(weakref.ref(t) for t in opt.state[lm.params["embed"]].values())]
    del lm, opt, step, tokens, targets
    gc.collect()
    assert len(programs) == 0
    assert [r() for r in held] == [None] * len(held)


def test_tp_over_gloo_on_one_card_matches_the_unsharded_model(card):
    """Two ranks of a model group on this card, joined by gloo (NCCL
    refuses two ranks on one card): bf16 at head dim 64, so every flash
    launch (2 q heads and 1 kv head a rank) takes the tensor-core route;
    the loss equals the unsharded model's within the kernels' bf16 band
    and the TP engine's greedy tokens equal the unsharded engine's."""
    from torch_ranks import spawn_ranks
    import torch_rank_workers
    hvd.shutdown()
    res = spawn_ranks(2, torch_rank_workers.tp_card, SMALL, timeout=300)
    for got in res:
        assert got["launches"]["flash_fwd_wgmma"] > 0
        assert got["launches"]["flash_bwd_dq_wgmma"] > 0
        assert got["launches"]["flash_bwd_dkv_wgmma"] > 0
        assert got["launches"]["flash_fwd"] == 0
        assert got["h_kv"] == 1
        assert abs(got["loss"] - got["ref_loss"]) <= 1e-2
        assert got["tokens"] == got["ref_tokens"]


def test_a_capture_after_every_graph_was_dropped(card):
    """Every graph of the session's pool may leave the cache with the
    step that dropped it; a later capture into the pool still works (the
    cache keeps the pool in use), and replays as its eager run does."""
    import gc
    batches = _batches(card, 3)
    for _ in range(2):
        _train(card, True, batches)
        gc.collect()
        assert len(hvd.runtime.live_state().programs) == 0
    got, step = _train(card, True, batches)
    want, _ = _train(card, False, batches)
    assert step.cache_misses == 1
    for a, b in zip(got.parameters(), want.parameters()):
        assert torch.equal(a, b)


def test_guarded_step_replayed_equals_the_plain_step(card, monkeypatch):
    """HOROVOD_GUARD=1 with no chaos spec, as a user runs it: the guarded
    program (health rows, the held copies and the gate, the backward
    from its device seed of 1.0) replayed on healthy batches leaves the
    parameters bitwise where the plain program's replays leave them, and
    every verdict applies."""
    batches = _batches(card, 4)
    want, _ = _train(card, True, batches)
    hvd.shutdown()
    monkeypatch.setenv("HOROVOD_GUARD", "1")
    hvd.init(device="cuda")
    skipped = hvd.metrics.GUARD_SKIPPED_STEPS.value()
    got, step = _train(card, True, batches)
    assert step.finish()["action"] == "apply"
    assert hvd.metrics.GUARD_SKIPPED_STEPS.value() == skipped
    assert step.cache_misses == 1 and step.fallback_steps == 0
    (sig,) = step._signatures
    assert sig[1] == "health"
    for a, b in zip(got.parameters(), want.parameters()):
        assert torch.equal(a, b)


def test_the_loader_stages_batches_while_steps_capture(card):
    """The input pipeline's producer gathers, pins and copies batches on
    its own thread while compiled steps warm up and capture their graphs
    on this one. Each batch is a new size (32 KB to 64 MB: every pin is a
    fresh pinned allocation and every copy a fresh card allocation) and
    each step a new program, so the producer's allocations meet the
    captures; no capture or batch fails, every batch lands with its
    bytes, and each replay's loss equals the eager loss of the same
    model on the same batch."""
    import threading
    import time
    sizes = [1 << (10 + k % 12) for k in range(24)]
    made = iter(sizes)
    lock = threading.Lock()

    def fetch(idx):
        with lock:
            n = next(made)
        rows = np.asarray(idx, dtype=np.float32)[:, None]
        time.sleep(0.002 * (n.bit_length() % 5))
        return {"x": np.repeat(rows, n, axis=1)}

    ds = hvd.data.DistributedDataset(fetch, 8, num_samples=8 * len(sizes),
                                     shuffle=False, prefetch=2, device=card)
    for k, batch in enumerate(ds):
        x = batch["x"]
        want = torch.arange(8 * k, 8 * k + 8, dtype=torch.float32,
                            device=card)[:, None].expand(8, sizes[k])
        assert torch.equal(x, want)
        gen = torch.Generator().manual_seed(k)
        w = torch.randn(16, 4, generator=gen).to(card)
        losses = []
        for compiled in (True, False):
            p = torch.nn.Parameter(w.clone())
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW([p], capturable=True, **ADAMW),
                named_parameters=[("w", p)])

            def loss(x, p=p):
                return torch.tanh(x[:, :16] / 64 @ p).square().mean()

            if compiled:
                step = hvd.compiled_train_step(loss, opt)
                for _ in range(3):
                    out = step(x)
                assert step.cache_misses == 1 and step.fallback_steps == 0
            else:
                for _ in range(3):
                    opt.zero_grad(set_to_none=True)
                    out = loss(x)
                    out.backward()
                    opt.step()
            losses.append(out.detach())
        torch.cuda.synchronize()
        assert torch.equal(losses[0], losses[1])


def test_the_pool_anchor_captures_while_another_thread_pins(card):
    """The session's graph pool is made by capturing a one-fill anchor
    graph at the first program's build, which may come while the input
    pipeline's producer pins and copies on its own thread. A capture in
    the default (global) mode is invalidated by such calls from any
    thread; the anchor captures thread-local, as the programs do. Twenty
    fresh pools, each captured while another thread pins host buffers
    and copies them to the card, all succeed."""
    import threading
    stop = threading.Event()
    errors = []

    def stage():
        n = 1 << 16
        try:
            while not stop.is_set():
                host = torch.empty(n, pin_memory=True)
                host.to(card, non_blocking=True)
                n = n * 2 if n < 1 << 24 else 1 << 16
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    programs = hvd.runtime.live_state().programs
    t = threading.Thread(target=stage, daemon=True)
    t.start()
    try:
        for _ in range(20):
            programs.clear()
            assert programs.graph_pool() is not None
    finally:
        stop.set()
        t.join(timeout=30)
    torch.cuda.synchronize()
    assert not errors, errors


def test_a_traced_replay_attributes_the_flash_kernels(card, tmp_path):
    """The phase trace of replayed compiled steps (diag/xla_trace.py):
    the program re-captures once for its phase map, every replayed
    kernel is matched, the flash kernels land in forward and backward
    alone, ``other`` stays under 5% of the device time, and the traced
    replays launch what untraced ones do."""
    cfg = tfm.TransformerConfig(loss_chunk=64, **SMALL)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
        named_parameters=lm.named_parameters())
    step = hvd.compiled_train_step(lm.loss, opt)
    tokens, targets = _batches(card, 1)[0]
    step(tokens, targets)
    step(tokens, targets)
    before = fa.launch_counts()
    step(tokens, targets)
    plain = {k: fa.launch_counts()[k] - n for k, n in before.items()}
    tracer = hvd.trace_steps(2, out_dir=str(tmp_path))
    before = fa.launch_counts()
    for _ in range(3):
        step(tokens, targets)
    torch.cuda.synchronize()
    traced = {k: (fa.launch_counts()[k] - n) / 3 for k, n in before.items()}
    assert traced == plain
    s = tracer.last_summary
    assert s["unmatched"] == 0 and s["graph_events"] > 0
    assert s["phases"]["other"] < 0.05 * s["total_s"]
    for name, phase in (("flash_fwd_wgmma_kernel", "forward"),
                        ("flash_bwd_dq_wgmma_kernel", "backward"),
                        ("flash_bwd_dkv_wgmma_kernel", "backward")):
        hits = [by for k, by in s["kernels"].items() if name in k]
        assert hits and all(set(by) == {phase} for by in hits), name
    assert step.flops_per_step > 0
