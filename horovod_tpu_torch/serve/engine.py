"""Serve engine: shape-binned prefill and decode over the paged KV pool.

Counterpart of horovod_tpu/serve/engine.py. Two paths:

- **prefill** runs the model's forward trunk
  (models/transformer.py:_attention_block_kv, so prompt attention goes
  through the flash kernel when ``attention_impl="flash"``) over a
  (batch_bin, len_bin) padded prompt batch, scattering each layer's K/V
  into the paged pool and returning the logits at each prompt's last
  real position;
- **decode** advances every active sequence one token: one-row
  attention against the paged pool
  (ops/flash_attention.py:paged_attention_decode), per-sequence rope
  positions (models/transformer.py:_rope_b), the new K/V row scattered
  into its page, and full-vocab logits.

Batch, prompt length and page-table width round up to powers of two
(config.next_power_of_two), the JAX engine's shape bins. Each bin's
prefill and decode is a program (ops/step_program.py: a CUDA graph on a
card) in a signature-keyed cache, the session's when ``hvd.init()`` has
run (as the JAX engine goes through its runtime's step-program tier),
else the engine's own: one graph per (prefill, batch_bin, len_bin,
page_bin) and per (decode, batch_bin, page_bin), whose tokens, lengths
and page tables are copied into static inputs (one host-to-card copy a
step) and whose logits are read from a static output. Hits and misses
by phase feed ``hvd_serve_program_cache_{hits,misses}``, a failed
session tier ``hvd_serve_fallback_steps_total``. With
``HOROVOD_STEP_PROGRAM=0`` (or ``HOROVOD_DEVICE_RESIDENT=0``) a card
runs each program without capturing it, as the CPU always does.

Where the JAX engine rebuilt the pools functionally, this one updates
them in place (``index_put_``), and ``defrag`` permutes them in place:
every captured graph holds the pools' addresses. A dead engine's
programs leave the session's cache with it.

``mesh``/``tp_axis`` shard the model Megatron-style over the
``tp_axis`` group of a ``DeviceMesh`` (models/transformer.py): each rank
of the group holds its shard of the parameters and of the KV pools,
split on the kv-head dimension, and the logits are gathered over the
vocabulary, so every rank selects the same token. The reference's engine
is one controller over a mesh; here every rank of the group runs an
engine, and every rank must make the same calls with the same
arguments, as in any SPMD program. The scheduler keeps its ranks so
(serve/scheduler.py: the group's rank 0 broadcasts each step's joins
and evictions, and every rank then allocates the same pages and samples
the same token); a caller that drives the engine directly passes the
same arguments on every rank itself.
"""

import time
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from .. import metrics, runtime
from ..config import next_power_of_two
from ..models import transformer as tfm
from ..ops.flash_attention import paged_attention_decode
from ..ops.step_program import StepProgram, engine_cached_program, obj_token
from ..utils.devices import resolve_device
from .kv_cache import PagedKVCache

# Knob defaults (config.py: HOROVOD_SERVE_*).
DEFAULT_PAGES = 512
DEFAULT_PAGE_SIZE = 16
DEFAULT_MAX_BATCH = 8


def _pool_scatter_prefill(pool, li, page_tables, positions, rows,
                          page_size):
    """Scatter (B, S, h, d) prefill rows into layer ``li`` of the pool,
    in place. Positions past a sequence's reserved pages hit null-page
    table slots, so padded prompt tails land on page 0 by construction.
    Several of them share a page-0 slot; which write wins is undefined
    on the card, and harmless, because no length mask ever admits page
    0 into a read."""
    pages = page_tables[:, positions // page_size]                 # (B, S)
    offs = (positions % page_size)[None].expand_as(pages)
    pool[li].index_put_((pages, offs), rows)


def _prefill_core(params, k_pool, v_pool, tokens, lengths, page_tables,
                  cfg, page_size, moe_full, tp):
    """Forward trunk + paged K/V capture + last-position logits; MoE
    layers at full capacity when ``moe_full``; sharded over the model
    group ``tp`` (None: unsharded). The phase trace's ``hvd_prefill``."""
    with record_function("hvd_prefill"):
        return _prefill(params, k_pool, v_pool, tokens, lengths,
                        page_tables, cfg, page_size, moe_full, tp)


def _prefill(params, k_pool, v_pool, tokens, lengths, page_tables, cfg,
             page_size, moe_full, tp):
    axes = tfm.ShardAxes(tp=tp)
    x = tfm.embed_tokens(params, tokens, cfg, axes)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for li, p in enumerate(params["layers"]):
        x, k, v = tfm._attention_block_kv(p, x, cfg, axes)
        _pool_scatter_prefill(k_pool, li, page_tables, positions, k,
                              page_size)
        _pool_scatter_prefill(v_pool, li, page_tables, positions, v,
                              page_size)
        x, _ = tfm._mlp_block(p, x, cfg, axes, moe_full_capacity=moe_full)
    # The head is row-wise, so it runs on the last real rows only instead
    # of on every position and then selecting.
    last = torch.clamp(lengths - 1, 0, tokens.shape[1] - 1)
    x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    logits = tfm._head(params, x, cfg)[:, 0]                   # (B, V_loc)
    return tfm._gather_vocab(logits, tp)                           # (B, V)


def _decode_core(params, k_pool, v_pool, tokens, lengths, page_tables,
                 cfg, page_size, moe_full, tp):
    """One token for every row: scatter the new K/V row at position
    ``lengths`` (in place) and attend over ``lengths + 1`` visible
    positions; sharded over the model group ``tp`` (None: unsharded).
    The phase trace's ``hvd_decode``."""
    with record_function("hvd_decode"):
        return _decode(params, k_pool, v_pool, tokens, lengths,
                       page_tables, cfg, page_size, moe_full, tp)


def _decode(params, k_pool, v_pool, tokens, lengths, page_tables, cfg,
            page_size, moe_full, tp):
    axes = tfm.ShardAxes(tp=tp)
    b = tokens.shape[0]
    x = tfm._embed_rows(params, tokens[:, None], tp)
    if cfg.positional == "learned":
        x = x + params["pos"][lengths][:, None]
    x = x.to(cfg.dtype)
    pages = page_tables[torch.arange(b, device=tokens.device),
                        lengths // page_size]
    offs = lengths % page_size
    for li, p in enumerate(params["layers"]):
        h = tfm._rmsnorm(x, p["ln1"])
        q, k_new, v_new = tfm._qkv_proj(p, h, cfg)
        if cfg.positional == "rope":
            q = tfm._rope_b(q, lengths[:, None])
            k_new = tfm._rope_b(k_new, lengths[:, None])
        k_pool[li].index_put_((pages, offs), k_new[:, 0])
        v_pool[li].index_put_((pages, offs), v_new[:, 0])
        attn = paged_attention_decode(q, k_pool[li], v_pool[li],
                                      page_tables, lengths + 1)
        out = tfm._einsum_f32("bshx,hxd->bsd", attn,
                              p["wo"].to(cfg.dtype))
        x = x + tfm._psum(out, tp).to(cfg.dtype)
        x, _ = tfm._mlp_block(p, x, cfg, axes, moe_full_capacity=moe_full)
    logits = tfm._head(params, x, cfg)[:, 0]                   # (B, V_loc)
    return tfm._gather_vocab(logits, tp)                           # (B, V)


class ServeEngine:
    """Owns the paged pools and runs binned prefill/decode.

    ``params`` is the model's parameter tree (models/transformer.py),
    on ``device``. ``batch_bin_floor``/``page_bin_floor``/
    ``len_bin_floor`` pin the minimum bin, which makes a sequence's
    stream independent of its neighbours (the churn-exactness contract).
    ``moe_full_capacity`` (default True, as the JAX engine's) runs MoE
    layers with ``t*k`` slots per expert: nothing drops, so a token's
    output does not depend on the rest of its batch, and the capacity is
    static per bin, so one program a bin still holds.
    ``prefill_hits``/``_misses`` and ``decode_hits``/``_misses`` count
    program fetches; ``fallback_steps`` counts steps whose session
    cache failed and that took the engine's own instead.

    ``mesh``/``tp_axis``: tensor-parallel serving over the ``tp_axis``
    group of ``mesh`` (a ``DeviceMesh``; module docstring). ``params``
    is the full tree, as the JAX engine's is; the engine cuts this
    rank's shard from it (``slice_param_shards``). The kv heads must
    divide over the group."""

    def __init__(self, params, cfg, *, mesh=None, tp_axis=None,
                 num_pages=DEFAULT_PAGES, page_size=DEFAULT_PAGE_SIZE,
                 max_pages_per_seq=None, batch_bin_floor=1,
                 page_bin_floor=1, len_bin_floor=1, moe_full_capacity=True,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.mesh = mesh
        self.tp_axis = tp_axis if mesh is not None else None
        self.tp = None
        if mesh is not None:
            if tp_axis is None:
                raise ValueError("mesh serving needs tp_axis")
            if params["embed"].shape[0] != cfg.vocab_size:
                raise ValueError(
                    f"mesh serving takes the full parameter tree: embed "
                    f"has {params['embed'].shape[0]} rows, the vocabulary "
                    f"{cfg.vocab_size}")
            self.tp = mesh.get_group(tp_axis)
            params = tfm.slice_param_shards(
                params, tfm.param_specs(cfg, tp=tp_axis, ep=None),
                {tp_axis: (dist.get_rank(self.tp),
                           dist.get_world_size(self.tp))})
        self.params = params
        self.moe_full_capacity = bool(moe_full_capacity)
        self.batch_bin_floor = max(int(batch_bin_floor), 1)
        self.page_bin_floor = max(int(page_bin_floor), 1)
        self.len_bin_floor = max(int(len_bin_floor), 1)
        h_kv = tfm._local_kv_heads(cfg, self.tp)
        if max_pages_per_seq is None:
            max_pages_per_seq = max(1, -(-cfg.max_seq // int(page_size)))
        self.cache = PagedKVCache(cfg.n_layers, h_kv, cfg.head_dim,
                                  num_pages, page_size, max_pages_per_seq,
                                  cfg.dtype)
        shape = (cfg.n_layers, num_pages, page_size, h_kv, cfg.head_dim)
        self._k_pool = torch.zeros(shape, dtype=cfg.dtype,
                                   device=self.device)
        self._v_pool = torch.zeros(shape, dtype=cfg.dtype,
                                   device=self.device)
        self._local_progs = {}
        self._local_pool = None
        self.prefill_hits = 0
        self.prefill_misses = 0
        self.decode_hits = 0
        self.decode_misses = 0
        self.fallback_steps = 0

    # --------------------------------------------------------- caching

    def _program(self, kind, signature, build):
        """The program of ``signature``: from the session's cache when
        there is a session (a failure there counts a fallback step and
        takes the engine's own cache), else from the engine's own."""
        was_hit = None
        if runtime.is_initialized():
            programs = runtime.live_state().programs

            def build_owned():
                # the engine's finalizer drops its programs from the
                # session's cache
                prog = build()
                weakref.finalize(self, programs.discard, signature)
                return prog

            try:
                prog, was_hit = engine_cached_program(signature,
                                                      build_owned)
            except Exception:  # noqa: BLE001 - counted, then served locally
                self.fallback_steps += 1
                metrics.SERVE_FALLBACK_STEPS.inc()
                was_hit = None
        if was_hit is None:
            was_hit = signature in self._local_progs
            if not was_hit:
                self._local_progs[signature] = build()
            prog = self._local_progs[signature]
        if kind == "prefill":
            self.prefill_hits += was_hit
            self.prefill_misses += not was_hit
            metrics.SERVE_PROGRAM_CACHE_HITS.labels(
                phase="prefill").set(self.prefill_hits)
            metrics.SERVE_PROGRAM_CACHE_MISSES.labels(
                phase="prefill").set(self.prefill_misses)
        else:
            self.decode_hits += was_hit
            self.decode_misses += not was_hit
            metrics.SERVE_PROGRAM_CACHE_HITS.labels(
                phase="decode").set(self.decode_hits)
            metrics.SERVE_PROGRAM_CACHE_MISSES.labels(
                phase="decode").set(self.decode_misses)
        return prog

    def decode_hit_rate(self):
        total = self.decode_hits + self.decode_misses
        return self.decode_hits / total if total else 0.0

    def _build(self, core, batch_bin, page_bin, len_bin=None):
        """A program running ``core`` on static int64 inputs: tokens
        (batch_bin, len_bin), or (batch_bin,) for decode, lengths
        (batch_bin,) and page tables (batch_bin, page_bin), views of one
        buffer that a step fills with one copy."""
        shape = (batch_bin,) if len_bin is None else (batch_bin, len_bin)
        sizes = (int(np.prod(shape)), batch_bin, batch_bin * page_bin)
        buf = torch.zeros(sum(sizes), dtype=torch.int64, device=self.device)
        tokens, lengths, tables = torch.split(buf, sizes)
        tokens = tokens.view(shape)
        tables = tables.view(batch_bin, page_bin)
        ps = self.cache.page_size
        # Weak: a session's cache may outlive the engine, and must not
        # keep its pools alive (a dead engine's token never hits again).
        ref = weakref.ref(self)

        def fn():
            eng = ref()
            return core(eng.params, eng._k_pool, eng._v_pool, tokens,
                        lengths, tables, eng.cfg, ps, eng.moe_full_capacity,
                        eng.tp)

        pool = None
        if self.device.type == "cuda":
            if runtime.is_initialized():
                pool = runtime.live_state().programs.graph_pool()
            else:
                if self._local_pool is None:
                    self._local_pool = torch.cuda.graph_pool_handle()
                pool = self._local_pool
        return StepProgram(fn, self.device, pool, [buf])

    def _run(self, prog, *arrays):
        """Fill ``prog``'s static inputs from host ``arrays`` (one copy)
        and run it; the logits on the host."""
        prog.inputs[0].copy_(torch.from_numpy(np.concatenate(
            [a.reshape(-1) for a in arrays])))
        return prog()

    def _page_bin(self, seq_ids, extra_pages=0):
        widest = max((len(self.cache.pages_of(s)) for s in seq_ids
                      if s is not None), default=1)
        return next_power_of_two(max(widest + extra_pages,
                                     self.page_bin_floor))

    def _tables(self, seq_ids, batch_bin, page_bin):
        rows = self.cache.page_table_rows(
            list(seq_ids) + [None] * (batch_bin - len(seq_ids)), page_bin)
        return np.asarray(rows, np.int64)

    # ------------------------------------------------------------ runs

    def prefill(self, seq_ids, prompts):
        """Run prompts (lists of token ids) for already-allocated
        sequences; returns (B, V) f32 logits at each prompt's last
        position — the distribution the FIRST generated token samples
        from."""
        b = len(seq_ids)
        ps = self.cache.page_size
        lens = [len(p) for p in prompts]
        len_bin = next_power_of_two(max(max(lens), self.len_bin_floor))
        batch_bin = next_power_of_two(max(b, self.batch_bin_floor))
        page_bin = max(self._page_bin(seq_ids),
                       next_power_of_two(-(-len_bin // ps)))
        tokens = np.zeros((batch_bin, len_bin), np.int64)
        lengths = np.zeros((batch_bin,), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
            lengths[i] = len(p)
        sig = ("serve_prefill", obj_token(self), self.cfg, batch_bin,
               len_bin, page_bin, ps, self.moe_full_capacity)
        prog = self._program("prefill", sig, lambda: self._build(
            _prefill_core, batch_bin, page_bin, len_bin))
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits = self._run(prog, tokens, lengths, self._tables(
                seq_ids, batch_bin, page_bin))
            logits = logits[:b].cpu().numpy()
        dt = time.perf_counter() - t0
        metrics.SERVE_STEP_SECONDS.labels(phase="prefill").observe(dt)
        metrics.SERVE_TOKENS.labels(phase="prefill").inc(sum(lens))
        self._observe_sentry(f"serve_prefill|b{batch_bin}|s{len_bin}", dt)
        return logits

    def decode(self, seq_ids, tokens, lengths):
        """One decode step for the active rows: ``tokens``/``lengths``
        are the per-sequence last token and current visible length.
        Returns (B, V) f32 logits for the NEXT token."""
        b = len(seq_ids)
        ps = self.cache.page_size
        batch_bin = next_power_of_two(max(b, self.batch_bin_floor))
        page_bin = self._page_bin(seq_ids)
        tok = np.zeros((batch_bin,), np.int64)
        tok[:b] = tokens
        lng = np.zeros((batch_bin,), np.int64)
        lng[:b] = lengths
        sig = ("serve_decode", obj_token(self), self.cfg, batch_bin,
               page_bin, ps, self.moe_full_capacity)
        prog = self._program("decode", sig, lambda: self._build(
            _decode_core, batch_bin, page_bin))
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits = self._run(prog, tok, lng, self._tables(
                seq_ids, batch_bin, page_bin))
            logits = logits[:b].cpu().numpy()
        dt = time.perf_counter() - t0
        metrics.SERVE_STEP_SECONDS.labels(phase="decode").observe(dt)
        metrics.SERVE_TOKENS.labels(phase="decode").inc(b)
        self._observe_sentry(f"serve_decode|b{batch_bin}|p{page_bin}", dt)
        return logits

    def _observe_sentry(self, signature, dt):
        """Feed the perf-regression sentry (diag/sentry.py) — decode
        signatures get the same EMA-baseline watch as train steps."""
        from ..diag import sentry as _sentry
        s = _sentry.get()
        if s is not None:
            s.observe(signature, dt)

    # ------------------------------------------------------ pool admin

    def defrag(self):
        """Compact live pages to the low end of the pool (one gather per
        cache side); returns the number of pages moved."""
        moves = self.cache.defrag()
        if not moves:
            return 0
        perm = np.arange(self.cache.num_pages)
        for src, dst in moves.items():
            perm[dst] = src
        perm = torch.from_numpy(perm).to(self.device)
        # In place: the captured graphs read the pools at their addresses.
        with torch.inference_mode():
            self._k_pool.copy_(self._k_pool[:, perm])
            self._v_pool.copy_(self._v_pool[:, perm])
        return len(moves)

    def update_pool_metrics(self):
        st = self.cache.stats()
        metrics.SERVE_KV_FREE_PAGES.set(st["free_pages"])
        metrics.SERVE_KV_PAGE_UTILIZATION.set(st["utilization"])
        metrics.SERVE_ACTIVE_SEQUENCES.set(st["active_sequences"])
        return st
