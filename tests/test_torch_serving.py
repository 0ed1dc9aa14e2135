"""The port's serving subsystem (horovod_tpu_torch/serve/) against the
JAX package's, and its own contracts.

- **paging**: the allocator cases of tests/test_serving.py
  (TestPagedKVCache) on the port's PagedKVCache;
- **numerics**: prefill plus teacher-forced decode logits of the port's
  ServeEngine against the JAX ServeEngine with the flash kernel in
  interpret mode (the recipe of tests/test_serving.py's parity cases),
  f32 greedy tokens identical;
- **null page**: padded prefill tails and padded decode rows write only
  page 0, and whatever page 0 holds never reaches a real sequence;
- **scheduling**: churned streams equal solo streams, cancel, bounded
  admission, the ``Engine`` submit/stream/close front door.

Tolerances: f32 logits hold to atol 1e-4, the band of the reference's
own serve-vs-forward check (tests/test_serving.py,
test_decode_learned_f32_exact_greedy). bf16 logits hold to atol 5e-2:
the JAX engine runs jitted programs, and XLA fuses bf16 casts inside a
program, so its rounding differs from the op-by-op rounding the port
mirrors by up to ~2e-2 on this model (measured against the JAX
package's own eager forward).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.models.transformer as jtfm
from horovod_tpu.serve.engine import ServeEngine as JaxServeEngine
from horovod_tpu_torch import metrics
from horovod_tpu_torch import serve
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.serve.engine import ServeEngine
from horovod_tpu_torch.serve.kv_cache import OutOfPages, PagedKVCache
from horovod_tpu_torch.serve.scheduler import (ContinuousBatcher, Request,
                                               ServeOverloaded)

F32_ATOL = 1e-4
BF16_ATOL = 5e-2


def _cfg(**kw):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=32, dtype=torch.float32, positional="rope",
                attention_impl="flash")
    base.update(kw)
    return tfm.TransformerConfig(**base)


def _params(cfg, seed=0):
    return tfm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _engine(cfg, params=None, **kw):
    return ServeEngine(params or _params(cfg), cfg, device="cpu", **kw)


# ------------------------------------------------------ paged KV cache


class TestPagedKVCache:
    def _cache(self, num_pages=8, page_size=4, max_pages=4):
        return PagedKVCache(2, 2, 8, num_pages, page_size, max_pages,
                            torch.float32)

    def test_alloc_free_reuse(self):
        c = self._cache()
        p0 = c.allocate("a", 7)          # 2 pages
        assert len(p0) == 2
        assert c.used_pages == 2 and c.free_pages == 5  # page 0 is null
        c.allocate("b", 4)               # 1 page
        assert c.active_sequences == 2
        c.free("a")
        assert c.used_pages == 1
        # LIFO free list: "a"'s freed pages are exactly what "c" gets
        p2 = c.allocate("c", 8)
        assert p2 == p0
        assert c.used_pages == 3
        assert 0 not in p2 and 0 not in c.pages_of("b")

    def test_out_of_pages_and_limits(self):
        c = self._cache(num_pages=4, page_size=4, max_pages=4)
        c.allocate("a", 12)              # all 3 usable pages
        assert not c.can_allocate(1)
        with pytest.raises(OutOfPages):
            c.allocate("b", 1)
        with pytest.raises(ValueError):
            c.allocate("a", 1)           # double-allocate
        c.free("a")
        assert c.can_allocate(12)
        with pytest.raises(ValueError):
            c.allocate("b", 100)         # exceeds max_pages_per_seq

    def test_page_table_rows_pad_with_null(self):
        c = self._cache()
        c.allocate("a", 5)
        rows = c.page_table_rows(["a", None], 4)
        assert len(rows) == 2 and len(rows[0]) == 4
        assert rows[0][:2] == list(c.pages_of("a"))
        assert rows[0][2:] == [0, 0] and rows[1] == [0, 0, 0, 0]

    def test_churn_accounting(self):
        c = self._cache(num_pages=16, page_size=4, max_pages=8)
        rng = np.random.default_rng(0)
        live = {}
        for i in range(200):
            if live and (len(live) == 3 or rng.random() < 0.5):
                sid = rng.choice(list(live))
                c.free(sid)
                del live[sid]
            else:
                n = int(rng.integers(1, 20))
                if c.can_allocate(n):
                    c.allocate(i, n)
                    live[i] = n
        assert c.used_pages + c.free_pages == c.num_pages - 1
        assert c.active_sequences == len(live)
        for sid, n in live.items():
            assert len(c.pages_of(sid)) == c.pages_for(n)
        st = c.stats()
        assert st["frees"] >= 1 and st["allocs"] >= st["frees"]

    def test_defrag_compacts_low(self):
        c = self._cache(num_pages=16, page_size=4, max_pages=8)
        for sid in "abcd":
            c.allocate(sid, 8)
        before = {sid: list(c.pages_of(sid)) for sid in "ac"}
        c.free("b")
        c.free("d")
        moves = c.defrag()
        live = sorted(p for sid in "ac" for p in c.pages_of(sid))
        assert live == list(range(1, 1 + len(live)))
        for sid in "ac":
            assert len(c.pages_of(sid)) == len(before[sid])
        for src, dst in moves.items():
            assert src > dst


# ------------------------------------------- prefill/decode numerics


def _drive_teacher_forced(eng, tokens, prompt):
    """Prefill the prompt then feed the remaining columns one decode
    step at a time; returns the logits rows of positions prompt-1 ..
    L-1."""
    b, length = tokens.shape
    sids = list(range(b))
    for s in sids:
        eng.cache.allocate(s, length)
    outs = [eng.prefill(sids, [list(tokens[i, :prompt]) for i in sids])]
    for i in range(prompt, length):
        outs.append(eng.decode(sids, tokens[:, i], [i] * b))
    return np.stack(outs)


@pytest.mark.parametrize("positional,dtype,kv_heads", [
    ("rope", "float32", None),
    ("learned", "float32", 2),
    ("rope", "bfloat16", 2),
])
def test_engine_matches_jax_engine(positional, dtype, kv_heads):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=16, positional=positional, n_kv_heads=kv_heads,
                attention_impl="flash")
    jcfg = jtfm.TransformerConfig(dtype=getattr(jnp, dtype),
                                  flash_interpret=True, **base)
    tcfg = tfm.TransformerConfig(dtype=getattr(torch, dtype), **base)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = tfm.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    b, length, prompt = 2, 8, 4
    tokens = np.random.default_rng(1).integers(0, 64, (b, length))
    kw = dict(num_pages=16, page_size=4, max_pages_per_seq=2,
              batch_bin_floor=b, page_bin_floor=2, len_bin_floor=length)
    want = _drive_teacher_forced(JaxServeEngine(jparams, jcfg, **kw),
                                 tokens, prompt)
    eng = ServeEngine(params, tcfg, device="cpu", **kw)
    got = _drive_teacher_forced(eng, tokens, prompt)
    assert eng.fallback_steps == 0
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


def test_decode_matches_own_forward():
    """Within the port, prefill + teacher-forced decode reproduce the
    training forward's rows (f32, both through the same op order)."""
    cfg = _cfg(n_kv_heads=2, max_seq=16)
    params = _params(cfg)
    tokens = np.random.default_rng(2).integers(0, 64, (2, 8))
    ref = tfm.forward(params, torch.from_numpy(tokens), cfg).numpy()
    eng = _engine(cfg, params, num_pages=16, page_size=4,
                  max_pages_per_seq=2, batch_bin_floor=2, page_bin_floor=2,
                  len_bin_floor=8)
    got = _drive_teacher_forced(eng, tokens, 4)
    np.testing.assert_allclose(got, np.stack([ref[:, i] for i in range(3, 8)]),
                               atol=F32_ATOL, rtol=0)


# --------------------------------------------------------- null page


def test_null_page_absorbs_padding_and_is_never_read():
    """Padded prompt tails and padded batch rows land on page 0 only;
    pages nobody owns stay untouched; and garbage in page 0 does not
    change a single logit."""
    cfg = _cfg(n_kv_heads=2)
    params = _params(cfg)
    kw = dict(num_pages=16, page_size=4, batch_bin_floor=4,
              len_bin_floor=8)

    def run(poison):
        eng = _engine(cfg, params, **kw)
        for sid, n in ((0, 7), (1, 9)):
            eng.cache.allocate(sid, n)
        owned = set(eng.cache.pages_of(0)) | set(eng.cache.pages_of(1))
        first = eng.prefill([0, 1], [[3, 1, 4], [1, 5, 9, 2, 6]])
        untouched = [p for p in range(1, 16) if p not in owned]
        assert torch.all(eng._k_pool[:, untouched] == 0)
        assert torch.all(eng._v_pool[:, untouched] == 0)
        assert torch.any(eng._k_pool[:, 0] != 0)   # padding went there
        if poison:
            eng._k_pool[:, 0] = 1e4
            eng._v_pool[:, 0] = -1e4
        steps = [eng.decode([0, 1], [7, 8], [3, 5]),
                 eng.decode([0, 1], [2, 2], [4, 6])]
        return np.stack([first, *steps])

    np.testing.assert_array_equal(run(poison=True), run(poison=False))


# ------------------------------------------------- scheduler semantics


def _churn_vs_solo(cfg, prompts, news, max_batch=3):
    params = _params(cfg)

    def make_engine():
        return _engine(cfg, params, num_pages=64, page_size=4,
                       batch_bin_floor=4, page_bin_floor=4,
                       len_bin_floor=8)

    eng = make_engine()
    bat = ContinuousBatcher(eng, queue_depth=16, max_batch=max_batch)
    reqs = [Request(p, n) for p, n in zip(prompts, news)]
    for r in reqs:
        bat.submit(r)
    bat.drain()
    churned = [list(r.generated) for r in reqs]
    solo = []
    for p, n in zip(prompts, news):
        b = ContinuousBatcher(make_engine(), queue_depth=4,
                              max_batch=max_batch)
        r = Request(p, n)
        b.submit(r)
        b.drain()
        solo.append(list(r.generated))
    return eng, churned, solo


def test_join_evict_churn_streams_exact():
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, 64, size=n)) for n in (3, 5, 2, 7, 4)]
    news = [6, 3, 8, 4, 5]
    eng, churned, solo = _churn_vs_solo(_cfg(), prompts, news)
    assert churned == solo
    assert [len(c) for c in churned] == news
    st = eng.cache.stats()
    assert st["active_sequences"] == 0
    assert st["free_pages"] == st["num_pages"] - 1


def test_moe_serve_churn_streams_exact():
    """Serving runs MoE layers at FULL capacity (capacity = tokens *
    top_k, models/moe.py): no token is ever dropped, so routing — and
    therefore every stream — stays batch-composition independent even
    with expert layers in the stack."""
    cfg = _cfg(moe_layers=(1,), moe_num_experts=4, moe_top_k=2)
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(0, 64, size=n)) for n in (4, 2, 6)]
    news = [5, 7, 3]
    eng, churned, solo = _churn_vs_solo(cfg, prompts, news, max_batch=2)
    assert eng.moe_full_capacity
    assert churned == solo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_engine_matches_jax_engine(dtype):
    """An MoE model's prefill and teacher-forced decode logits against
    the JAX engine (full capacity on both), at this file's bands; f32
    greedy tokens identical."""
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=16, positional="rope", n_kv_heads=2,
                attention_impl="flash", moe_layers=(1,), moe_num_experts=4,
                moe_top_k=2)
    jcfg = jtfm.TransformerConfig(dtype=getattr(jnp, dtype),
                                  flash_interpret=True, **base)
    tcfg = tfm.TransformerConfig(dtype=getattr(torch, dtype), **base)
    jparams = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    params = tfm.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    b, length, prompt = 2, 8, 4
    tokens = np.random.default_rng(4).integers(0, 64, (b, length))
    kw = dict(num_pages=16, page_size=4, max_pages_per_seq=2,
              batch_bin_floor=b, page_bin_floor=2, len_bin_floor=length)
    want = _drive_teacher_forced(JaxServeEngine(jparams, jcfg, **kw),
                                 tokens, prompt)
    got = _drive_teacher_forced(ServeEngine(params, tcfg, device="cpu",
                                            **kw), tokens, prompt)
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


def test_cancel_frees_pages():
    cfg = _cfg()
    eng = _engine(cfg, num_pages=32, page_size=4)
    bat = ContinuousBatcher(eng, queue_depth=4, max_batch=2)
    req = Request([5, 6, 7], 20)
    bat.submit(req)
    bat.step()
    assert bat.active == 1 and eng.cache.active_sequences == 1
    bat.cancel(req)
    assert bat.active == 1          # nothing mutated inline
    bat.step()
    assert bat.active == 0 and eng.cache.active_sequences == 0
    assert req.finished


def test_cancel_cross_thread_midstream():
    cfg = _cfg()
    with serve.Engine(cfg, _params(cfg), num_pages=32, page_size=4,
                      max_batch=4, queue_depth=8, device="cpu") as eng:
        h = eng.submit([1, 2, 3], max_new_tokens=12)
        it = iter(h)
        next(it)
        h.cancel()
        tail = list(it)
        assert h.request.finished and len(tail) <= 11
        assert eng._thread.is_alive()
        h2 = eng.submit([4, 5], max_new_tokens=3)
        assert len(eng.result(h2)) == 3
    assert eng.engine.cache.active_sequences == 0


def test_admission_backpressure():
    cfg = _cfg()
    eng = _engine(cfg, num_pages=32, page_size=4)
    bat = ContinuousBatcher(eng, queue_depth=2, max_batch=2)
    bat.submit(Request([1], 2), timeout=0)
    bat.submit(Request([2], 2), timeout=0)
    rejected0 = metrics.SERVE_REQUESTS.labels(outcome="rejected").value()
    with pytest.raises(ServeOverloaded):
        bat.submit(Request([3], 2), timeout=0)
    assert (metrics.SERVE_REQUESTS.labels(outcome="rejected").value()
            == rejected0 + 1)
    bat.drain()
    # a request whose lifetime cannot be reserved yet waits at the head
    small = _engine(cfg, num_pages=5, page_size=4, max_pages_per_seq=4)
    b2 = ContinuousBatcher(small, queue_depth=4, max_batch=2)
    big = Request(list(range(1, 9)), 8)       # 4 pages = whole pool
    small_req = Request([1, 2], 2)
    b2.submit(small_req)
    b2.submit(big)
    b2.step()
    assert small_req.finished
    assert b2.active == 0 and b2.queue_depth() == 1
    b2.drain()
    assert len(big.generated) == 8
    with pytest.raises(ValueError, match="never"):
        b2.submit(Request(list(range(1, 12)), 8))  # 5 pages > 4


def test_api_engine_submit_stream_close(tmp_path, monkeypatch):
    """The front door: knobs from the environment, streaming, the SLO
    signal file, and a close() that drains."""
    monkeypatch.setenv("HOROVOD_SERVE_PAGE_SIZE", "4")
    monkeypatch.setenv("HOROVOD_SERVE_PAGES", "32")
    monkeypatch.setenv("HOROVOD_ELASTIC_POLICY_DIR", str(tmp_path))
    cfg = _cfg()
    with serve.Engine(cfg, _params(cfg), max_batch=4, queue_depth=8,
                      device="cpu") as eng:
        assert eng.engine.cache.page_size == 4
        assert eng.engine.cache.num_pages == 32
        h1 = eng.submit([1, 2, 3], max_new_tokens=5)
        h2 = eng.submit([9, 8], max_new_tokens=3)
        toks = list(h1)
        assert toks == h1.request.generated and len(toks) == 5
        assert len(eng.result(h2)) == 3
        sig = eng.write_slo_signal()
    assert sig["p99_latency"] > 0
    assert (tmp_path / "signals-serve0.json").exists()
    assert eng.batcher.active == 0
    assert eng.engine.cache.active_sequences == 0


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_close_drain_detects_dead_loop():
    cfg = _cfg()
    eng = serve.Engine(cfg, _params(cfg), num_pages=32, page_size=4,
                       max_batch=2, queue_depth=4, start=False,
                       device="cpu")

    def boom():
        raise RuntimeError("injected step failure")

    eng.batcher.step = boom
    eng._thread = threading.Thread(target=eng._loop, daemon=True)
    eng._thread.start()
    eng._thread.join(timeout=10.0)
    assert not eng._thread.is_alive()
    eng.batcher.submit(Request([1, 2], 2))
    with pytest.raises(RuntimeError, match="died"):
        eng.close(drain=True)


def test_engine_rejects_tensor_parallel_serving():
    """Tensor-parallel serving (run over a model group of 2 in
    tests/test_torch_tensor_parallel.py): a mesh without a ``tp_axis``
    is refused in the reference's words, a tree already cut to a shard
    is refused (the engine takes the full tree, as the reference's
    does), and over a group of one rank the engine is the unsharded
    engine, bit for bit."""
    import horovod_tpu_torch as hvd
    cfg = _cfg()
    hvd.init(device="cpu")
    try:
        mesh = hvd.mesh()
        with pytest.raises(ValueError, match="mesh serving needs tp_axis"):
            ServeEngine(_params(cfg), cfg, mesh=mesh, device="cpu")
        shard = tfm.slice_param_shards(_params(cfg), tfm.param_specs(cfg),
                                       {"model": (0, 2)})
        with pytest.raises(ValueError, match="takes the full parameter"):
            ServeEngine(shard, cfg, mesh=mesh, tp_axis="hvd", device="cpu")
        tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8))
        kw = dict(num_pages=16, page_size=4, batch_bin_floor=2,
                  page_bin_floor=2, len_bin_floor=8)
        ref = _drive_teacher_forced(_engine(cfg, **kw), tokens, 4)
        got = _drive_teacher_forced(
            _engine(cfg, mesh=mesh, tp_axis="hvd", **kw), tokens, 4)
        np.testing.assert_array_equal(got, ref)
    finally:
        hvd.shutdown()


# ------------------------------------------------------ program cache


def _cache_sequence(eng, batcher_cls, request_cls):
    """The request sequence of the reference's
    test_decode_program_cache_steady_state: 4 requests of 5 prompt
    tokens and 12 new, numpy seed 3, through a batcher of width 4."""
    bat = batcher_cls(eng, queue_depth=8, max_batch=4)
    rng = np.random.default_rng(3)
    reqs = [request_cls(list(rng.integers(0, 64, size=5)), 12)
            for _ in range(4)]
    for r in reqs:
        bat.submit(r)
    bat.drain()
    return [list(r.generated) for r in reqs]


def test_decode_program_cache_steady_state():
    """One program per live bin: the first decode builds it and every
    later one hits (rate >= 0.9, no fallback), with the prefill and
    decode hit and miss counts of the JAX engine on the same requests,
    and its f32 greedy tokens."""
    from horovod_tpu.serve.scheduler import ContinuousBatcher as JaxBatcher
    from horovod_tpu.serve.scheduler import Request as JaxRequest
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=32, positional="rope", attention_impl="flash")
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, flash_interpret=True,
                                  **base)
    cfg = tfm.TransformerConfig(dtype=torch.float32, **base)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = tfm.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
    kw = dict(num_pages=32, page_size=4, batch_bin_floor=4,
              page_bin_floor=4, len_bin_floor=8)
    jeng = JaxServeEngine(jparams, jcfg, **kw)
    want = _cache_sequence(jeng, JaxBatcher, JaxRequest)
    eng = ServeEngine(params, cfg, device="cpu", **kw)
    got = _cache_sequence(eng, ContinuousBatcher, Request)
    assert got == want
    assert eng.decode_hits + eng.decode_misses >= 10
    assert eng.decode_misses == 1
    assert eng.decode_hit_rate() >= 0.9
    assert eng.fallback_steps == 0
    counts = (eng.prefill_hits, eng.prefill_misses, eng.decode_hits,
              eng.decode_misses)
    assert counts == (jeng.prefill_hits, jeng.prefill_misses,
                      jeng.decode_hits, jeng.decode_misses)
    values = metrics.snapshot()["hvd_serve_program_cache_hits"]["values"]
    assert values['phase="decode"'] == eng.decode_hits


def test_programs_use_the_session_cache_and_count_its_failures(monkeypatch):
    """Under hvd.init() the engine's programs live in the session's
    program cache, beside the train step's; a failing session tier is
    counted as a fallback step and the engine's own cache serves."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.serve import engine as engine_mod
    cfg = _cfg()
    prompts = [[3, 1, 4], [1, 5]]
    hvd.init(device="cpu")
    try:
        programs = hvd.runtime.live_state().programs
        eng = _engine(cfg, num_pages=16, page_size=4)
        bat = ContinuousBatcher(eng, queue_depth=4, max_batch=2)
        reqs = [Request(p, 4) for p in prompts]
        for r in reqs:
            bat.submit(r)
        bat.drain()
        assert len(programs) == eng.prefill_misses + eng.decode_misses
        assert programs.hits == eng.prefill_hits + eng.decode_hits
        assert eng.fallback_steps == 0

        def broken(signature, build):
            raise RuntimeError("session tier down")

        monkeypatch.setattr(engine_mod, "engine_cached_program", broken)
        fallback0 = metrics.SERVE_FALLBACK_STEPS.value()
        local = _engine(cfg, num_pages=16, page_size=4)
        bat = ContinuousBatcher(local, queue_depth=4, max_batch=2)
        again = [Request(p, 4) for p in prompts]
        for r in again:
            bat.submit(r)
        bat.drain()
        steps = (local.prefill_hits + local.prefill_misses
                 + local.decode_hits + local.decode_misses)
        assert local.fallback_steps == steps > 0
        assert metrics.SERVE_FALLBACK_STEPS.value() == fallback0 + steps
        assert [r.generated for r in again] == [r.generated for r in reqs]
    finally:
        hvd.shutdown()


def test_defrag_permutes_the_pools_in_place():
    """defrag moves live pages down inside the same pool tensors (a
    captured graph reads them at their addresses), and decoding after it
    gives the logits of an engine that never defragmented."""
    cfg = _cfg(n_kv_heads=2)
    params = _params(cfg)
    kw = dict(num_pages=16, page_size=4, batch_bin_floor=2,
              page_bin_floor=4, len_bin_floor=8)

    def run(defrag):
        eng = _engine(cfg, params, **kw)
        for sid, n in ((0, 12), (1, 12), (2, 12)):
            eng.cache.allocate(sid, n)
        eng.prefill([0, 1, 2], [[3, 1, 4, 1], [5, 9, 2, 6], [5, 3, 5, 8]])
        eng.cache.free(1)
        ptrs = (eng._k_pool.data_ptr(), eng._v_pool.data_ptr())
        moved = eng.defrag() if defrag else 0
        assert (eng._k_pool.data_ptr(), eng._v_pool.data_ptr()) == ptrs
        rows = [eng.decode([0, 2], [7, 9], [4, 4]),
                eng.decode([0, 2], [2, 3], [5, 5])]
        return moved, np.stack(rows)

    moved, got = run(defrag=True)
    assert moved > 0
    np.testing.assert_array_equal(got, run(defrag=False)[1])
