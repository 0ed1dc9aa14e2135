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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs do not run on the "
                    "CPU")
    hvd.init(device="cuda")
    yield hvd.runtime.device()
    hvd.shutdown()


def _train(card, compiled, batches, **kw):
    cfg = tfm.TransformerConfig(loss_chunk=64, **SMALL)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card)
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


def _serve(card, monkeypatch, capture):
    monkeypatch.setenv("HOROVOD_STEP_PROGRAM", "1" if capture else "0")
    cfg = tfm.TransformerConfig(**SMALL)
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
