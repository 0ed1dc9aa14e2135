"""Flagship transformer train-step benchmark: tokens/s and MFU.

Counterpart of bench_transformer.py's training bench (``build_cfg``,
``matmul_param_count``, ``flops_per_token``, ``parse_args``,
``run_benchmark``), on one card per rank:

    python -m horovod_tpu_torch.bench.transformer [--iters N] ...

The protocol is the reference's: the TransformerLM (flash attention,
bf16 activations, f32 parameters, rope, chunked cross entropy) trained
on synthetic tokens under ``DistributedOptimizer(AdamW(3e-4))``, two
untimed warm-up iterations, then ``--iters`` iterations of
STEPS_PER_ITER steps, each timed to a synchronize; the mean and 1.96
sigma of tokens/s per chip. Where the reference fuses an iteration's
steps into one program (``lax.scan``), the port runs them as an eager
loop. Attention runs the hand kernels ``flash_fwd.cu`` and
``flash_bwd.cu`` on their tensor-core route.

The device-side rate divides the tokens by the iteration's time on the
card's stream (CUDA events) where the reference subtracts a measured
dispatch overhead, and ``dispatch_overhead_ms`` is the mean of wall less
stream time an iteration. MFU: the analytic model FLOPs (6 x matmul
params + 6 x L x S x d_model, causal attention at half of S^2) times the
device-side rate over the card's peak (``hardware.py``); None where the
peak is unknown, as on the CPU. ``--device cpu`` runs the plain versions
of the kernels, for the tests only.

``--mesh3d`` runs the composable-parallelism scenario instead
(``run_mesh3d_benchmark``, bench_transformer.py's, with its flags and
defaults): a small TransformerLM (d_model 64, 2 layers, vocab 256, f32,
rope, dense attention) whose trunk is tensor-parallel over the ``model``
axis and whose last FFN is an expert-parallel MoE layer over ``ep``,
trained with SGD(0.05) and ZeRO-2 striping over the data axis through
one ``compiled_train_step`` on the 3-D (data, expert, model) mesh of
``--mesh3d-ep`` x ``--mesh3d-mp`` (re-initializing with
``HOROVOD_EXPERT_PARALLEL``/``HOROVOD_MODEL_PARALLEL`` when the runtime
has no model mesh; a world those do not divide raises the reference's
error). It prints the reference's ``mesh3d`` keys: tokens/s per chip,
the cache counters, and the largest parameter difference from the same
spec at ZeRO stage 0 after 5 steps.

``--moe`` runs the expert-parallel MoE scenario instead
(``run_moe_benchmark``, bench_transformer.py's, with its flags and
defaults): the capacity-routed MoE layer (d_model 256, d_ff 1024, E 8,
top-2, capacity factor 2.0, f32; 32 sequences of 64 tokens over every
rank) trained with SGD(0.05) through ``compiled_train_step`` under
``DistributedOptimizer(expert_keys=("w1", "w2"))`` on the expert mesh of
``--expert-parallel`` ranks, the dispatch and combine all-to-all cut
into ``--moe-chunks`` slices. On one card the run is ``--expert-parallel
1``: every expert on the card, no all-to-all. It prints the reference's
``moe`` keys: tokens/s per chip over max(iters, 8) timed steps, the
program cache's counters and the routing's drop fraction from one
``with_stats`` evaluation (fed to the ``hvd_moe_*`` families). After
the timed loop, 4 steps are traced (``hvd.trace_steps``,
:func:`trace_window`): ``step_phase_breakdown`` (device ms a step by
phase), ``xla_trace_dir``, and the all-to-all's device ms a step and
the fraction of it hidden under the expert FFN, which read None where
no all-to-all ran (``--expert-parallel 1``), as the reference's parser
gives them when the capture holds none.

``--serve`` runs the serving scenario instead (``run_serve_benchmark``,
bench_transformer.py's): the continuous-batching engine at
``--serve-streams`` concurrent streams of a small MHA model (f32, dense
attention, rope), on one card. Its bin floors pin one prefill and one
decode program (on a card, one CUDA graph each) for the run: an untimed
round builds them, the timed round reports TTFT and per-token latency
p50/p99, tokens/s and the program-cache hit rates under the serve
sub-dict's keys. Over more than one rank the model is tensor-parallel
over every rank (``mesh()``, axis ``hvd``), as the reference serves on
its mesh: each rank runs the engine in lockstep with rank 0.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import config as config_mod
from .. import hardware, metrics
from .. import optimizers, runtime
from ..exceptions import HorovodError
from .. import serve as hvd_serve
from ..models import moe as moe_lib
from ..models import transformer as tfm
from ..ops.collectives import allreduce
from ..ops.step_program import compiled_train_step

ITERS = 10
STEPS_PER_ITER = 5
# optax.adamw(3e-4)'s hyperparameters (torch's AdamW defaults its weight
# decay to 1e-2; optax to 1e-4).
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def build_cfg(args):
    return tfm.TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.heads,
        n_kv_heads=args.kv_heads or None, n_layers=args.layers,
        d_ff=4 * args.d_model, max_seq=args.seq_len, dtype=torch.bfloat16,
        positional="rope", attention_impl="dense" if args.dense else "flash",
        loss_chunk=args.loss_chunk, remat=args.remat)


def matmul_param_count(params):
    """Parameters on the matrix-product path: q/k/v, o, the MLP and the
    LM head. The embedding table (a gather) and the norm scales are left
    out by the MFU convention."""
    total = 0
    for layer in params["layers"]:
        for k, v in layer.items():
            if k.startswith(("wq", "wk", "wo", "w1", "w2", "moe")):
                total += sum(x.numel() for x in tfm._leaves(v)) \
                    if isinstance(v, dict) else v.numel()
    return total + params["lm_head"].numel()


def flops_per_token(params, cfg):
    """Train-step (forward + backward = 3x forward) matmul FLOPs per
    token."""
    attn = cfg.n_layers * cfg.max_seq * cfg.d_model  # causal half of S^2
    return 6 * matmul_param_count(params) + 6 * attn


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # The reference's defaults: the flagship at per-chip batch 4 x 4096.
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--kv-heads", type=int, default=-1,
                    help="grouped-query attention KV head count; 0 = MHA, "
                         "-1 (default) = heads/4 when divisible else MHA")
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--batch-per-chip", type=int, default=4)
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each layer: ~1/3 more FLOPs for "
                         "O(layers) less activation memory")
    ap.add_argument("--dense", action="store_true",
                    help="dense attention instead of the flash kernels")
    ap.add_argument("--moe", action="store_true",
                    help="run the expert-parallel MoE scenario instead: "
                         "2-D (data, expert) mesh, chunked alltoall "
                         "dispatch/combine")
    ap.add_argument("--expert-parallel", type=int, default=4,
                    help="expert-axis size of the 2-D mesh the MoE "
                         "scenario re-inits with when the runtime has "
                         "none (HOROVOD_EXPERT_PARALLEL); 1 on one card")
    ap.add_argument("--moe-chunks", type=int, default=8,
                    help="capacity slices the dispatch/combine alltoall "
                         "is pipelined into (HOROVOD_MOE_CHUNKS; 1 = "
                         "unchunked, bit-identical either way)")
    ap.add_argument("--moe-experts", type=int, default=8)
    ap.add_argument("--moe-capacity-factor", type=float, default=2.0)
    ap.add_argument("--moe-batch", type=int, default=32,
                    help="GLOBAL sequence count for the MoE scenario "
                         "(split over every rank)")
    ap.add_argument("--moe-seq", type=int, default=64)
    ap.add_argument("--moe-d-model", type=int, default=256)
    ap.add_argument("--moe-d-ff", type=int, default=1024)
    ap.add_argument("--mesh3d", action="store_true",
                    help="run the composable-parallelism scenario "
                         "instead: a TP dense trunk + expert-parallel "
                         "MoE FFN + ZeRO-2 striping in one compiled step "
                         "on the 3-D (data, expert, model) mesh")
    ap.add_argument("--mesh3d-ep", type=int, default=2,
                    help="expert-axis size of the 3-D mesh "
                         "(HOROVOD_EXPERT_PARALLEL)")
    ap.add_argument("--mesh3d-mp", type=int, default=2,
                    help="model-axis size of the 3-D mesh "
                         "(HOROVOD_MODEL_PARALLEL)")
    ap.add_argument("--mesh3d-batch", type=int, default=16,
                    help="GLOBAL sequence count (sharded over the data "
                         "and expert axes, replicated over model)")
    ap.add_argument("--mesh3d-seq", type=int, default=32)
    ap.add_argument("--mesh3d-d-model", type=int, default=64)
    ap.add_argument("--mesh3d-layers", type=int, default=2)
    ap.add_argument("--mesh3d-vocab", type=int, default=256)
    ap.add_argument("--serve", action="store_true",
                    help="run the continuous-batching serving scenario "
                         "instead: TTFT and per-token latency percentiles "
                         "plus tokens/sec at N concurrent streams")
    ap.add_argument("--serve-streams", type=int, default=8,
                    help="concurrent generation streams")
    ap.add_argument("--serve-prompt-len", type=int, default=16)
    ap.add_argument("--serve-new-tokens", type=int, default=32)
    ap.add_argument("--serve-page-size", type=int, default=16,
                    help="KV pool page size in tokens "
                         "(HOROVOD_SERVE_PAGE_SIZE)")
    ap.add_argument("--serve-d-model", type=int, default=128)
    ap.add_argument("--serve-layers", type=int, default=2)
    ap.add_argument("--serve-heads", type=int, default=8)
    ap.add_argument("--serve-vocab", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the tests: plain versions "
                         "of the kernels, no MFU)")
    args = ap.parse_args(argv)
    if args.kv_heads == -1:
        args.kv_heads = args.heads // 4 if args.heads % 4 == 0 else 0
    return args


def _tokens(cfg, batch, seq, device):
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    return tokens.to(device), torch.roll(tokens, -1, dims=1).to(device)


def run_benchmark(args):
    """The measurement without printing: ``bench.resnet`` embeds it at
    reduced iters. Returns the result dict (the reference's keys)."""
    runtime.init(device=args.device)
    device = runtime.device()
    cuda = device.type == "cuda"
    cfg = build_cfg(args)
    model = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                              device=device)
    optimizers.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = optimizers.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **ADAMW),
        named_parameters=model.named_parameters())
    tokens, targets = _tokens(cfg, args.batch_per_chip, args.seq_len, device)

    def one_iter():
        for _ in range(STEPS_PER_ITER):
            opt.zero_grad(set_to_none=True)
            loss = model.loss(tokens, targets)
            loss.backward()
            opt.step()
        return loss.detach()

    for _ in range(2):  # untimed warm-up, as the reference compiles twice
        float(one_iter())

    tok_per_iter = args.batch_per_chip * args.seq_len * STEPS_PER_ITER
    rates, dev_rates, overheads = [], [], []
    for _ in range(args.iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        loss = one_iter()
        if cuda:
            end.record()
        float(loss)  # the barrier: the loss is read on the host
        wall = time.perf_counter() - t0
        rates.append(tok_per_iter / wall)
        if cuda:
            dev = start.elapsed_time(end) / 1e3
            dev_rates.append(tok_per_iter / dev)
            overheads.append(max(wall - dev, 0.0))
    mean = float(np.mean(rates))
    conf = float(1.96 * np.std(rates))
    dev_mean = float(np.mean(dev_rates)) if cuda else None
    overhead_ms = float(np.mean(overheads)) * 1e3 if cuda else None

    ftok = flops_per_token(model.params, cfg)
    peak = hardware.peak_flops_per_chip(config_mod.Config.from_env(), device)
    mfu = None
    if peak and dev_mean:
        mfu = ftok * dev_mean / peak * 100.0
    card = hardware.card_line(device.index or 0) if cuda else None
    print(f"# Tokens/sec per chip on {card or 'cpu'}: {mean:,.0f} "
          f"+-{conf:,.0f} "
          f"(device-side {dev_mean}) at batch {args.batch_per_chip} x seq "
          f"{args.seq_len}, {ftok / 1e6:.0f} MFLOPs/token, MFU "
          f"{mfu if mfu is None else round(mfu, 2)}%", file=sys.stderr)
    del opt, model
    return {
        "metric": "transformer_tokens_per_sec_per_chip",
        "value": round(mean, 1),
        "unit": "tokens/sec",
        "tokens_per_sec_device_side": None if dev_mean is None
        else round(dev_mean, 1),
        "mfu_pct": None if mfu is None else round(mfu, 2),
        "flops_per_token": ftok,
        "batch_per_chip": args.batch_per_chip,
        "seq_len": args.seq_len,
        "d_model": args.d_model,
        "layers": args.layers,
        "attention": "dense" if args.dense else "flash",
        "dispatch_overhead_ms": None if overhead_ms is None
        else round(overhead_ms, 2),
        "card": card,
    }


def _ms(samples, q):
    return round(float(np.percentile(samples, q)) * 1e3, 3)


def run_serve_benchmark(args):
    """The serving scenario (bench_transformer.py's run_serve_benchmark,
    on one card): returns the result dict whose ``"serve"`` sub-dict
    carries the reference's keys."""
    runtime.init(device=args.device)
    device = runtime.device()
    n = runtime.size()
    streams = max(int(args.serve_streams), 1)
    prompt_len = max(int(args.serve_prompt_len), 1)
    new_tokens = max(int(args.serve_new_tokens), 2)
    page_size = max(int(args.serve_page_size), 1)
    pages_per_seq = -(-(prompt_len + new_tokens) // page_size)
    # headroom: two full generations' worth of pages + the null page
    num_pages = 1 + 2 * streams * pages_per_seq
    cfg = tfm.TransformerConfig(
        vocab_size=args.serve_vocab, d_model=args.serve_d_model,
        n_heads=args.serve_heads, n_kv_heads=None,
        n_layers=args.serve_layers, d_ff=4 * args.serve_d_model,
        max_seq=prompt_len + new_tokens, dtype=torch.float32,
        positional="rope", attention_impl="dense")
    if cfg.n_heads % n:
        raise ValueError(f"--serve-heads {cfg.n_heads} not divisible by "
                         f"world size {n}")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), device)
    # Tensor-parallel over every rank when there are several, as the
    # reference serves on its mesh.
    mesh = runtime.mesh() if n > 1 else None
    # Bin floors pinned to the stream count: one prefill and one decode
    # signature for the whole run.
    eng = hvd_serve.Engine(
        cfg, params, mesh=mesh, tp_axis="hvd" if mesh else None,
        num_pages=num_pages, page_size=page_size,
        max_batch=streams, queue_depth=max(2 * streams, 8), start=False,
        batch_bin_floor=streams, page_bin_floor=pages_per_seq,
        len_bin_floor=prompt_len, device=device)
    se = eng.engine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=prompt_len).tolist()
               for _ in range(streams)]

    def run_round():
        handles = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        t0 = time.perf_counter()
        eng.batcher.drain()
        wall = time.perf_counter() - t0
        return handles, sum(len(h.request.generated) for h in handles), wall

    run_round()  # untimed: builds (captures) both binned programs
    eng.batcher.recent_ttft.clear()
    eng.batcher.recent_token_latency.clear()
    dh0, dm0 = se.decode_hits, se.decode_misses
    handles, toks, wall = run_round()
    tps = toks / wall
    ttft = np.asarray([h.request.first_token_t - h.request.submitted_t
                       for h in handles])
    tok_lat = np.asarray(eng.batcher.recent_token_latency)
    dh, dm = se.decode_hits - dh0, se.decode_misses - dm0
    steady_hit_rate = dh / max(dh + dm, 1)
    sig = eng.write_slo_signal()
    pool = se.update_pool_metrics()
    card = hardware.card_line(device.index or 0) \
        if device.type == "cuda" else None
    print(f"# Serve tokens/sec on {card or 'cpu'}: {tps:,.0f} at {streams} "
          f"streams x {new_tokens} new tokens (prompt {prompt_len}), TTFT "
          f"p99 {np.percentile(ttft, 99) * 1e3:.1f} ms, token latency p99 "
          f"{np.percentile(tok_lat, 99) * 1e3:.1f} ms, decode hit rate "
          f"{se.decode_hit_rate():.2f} (steady {steady_hit_rate:.2f}), "
          f"fallbacks {se.fallback_steps}", file=sys.stderr)
    return {
        "metric": "serve_tokens_per_sec",
        "value": round(tps, 1),
        "unit": "tokens/sec",
        "serve": {
            "tokens_per_sec": round(tps, 1),
            "streams": streams,
            "prompt_len": prompt_len,
            "new_tokens": new_tokens,
            "ttft_p50_ms": _ms(ttft, 50),
            "ttft_p99_ms": _ms(ttft, 99),
            "token_latency_p50_ms": _ms(tok_lat, 50),
            "token_latency_p99_ms": _ms(tok_lat, 99),
            "slo_p99_latency_s": round(float(sig["p99_latency"]), 6),
            "decode_cache_hit_rate": round(se.decode_hit_rate(), 4),
            "steady_state_decode_hit_rate": round(steady_hit_rate, 4),
            "prefill_cache_hits": se.prefill_hits,
            "prefill_cache_misses": se.prefill_misses,
            "decode_cache_hits": se.decode_hits,
            "decode_cache_misses": se.decode_misses,
            "fallback_steps": se.fallback_steps,
            "page_size": page_size,
            "num_pages": num_pages,
            "kv_page_utilization": round(pool["utilization"], 4),
            "scheduler_steps": eng.batcher.steps,
            "d_model": cfg.d_model,
            "layers": cfg.n_layers,
            "heads": cfg.n_heads,
            "vocab": cfg.vocab_size,
            "devices": runtime.size(),
            "card": card,
        },
    }


def _mesh3d_runtime(args):
    """The 3-D (data, expert, model) mesh, re-initializing the runtime
    with ``--mesh3d-ep``/``--mesh3d-mp`` when it has none (a world they
    do not divide raises the reference's error from ``init()``)."""
    runtime.init(device=args.device)
    try:
        return runtime.model_mesh()
    except HorovodError:
        runtime.shutdown()
        os.environ["HOROVOD_EXPERT_PARALLEL"] = str(args.mesh3d_ep)
        os.environ["HOROVOD_MODEL_PARALLEL"] = str(args.mesh3d_mp)
        runtime.init(device=args.device)
        return runtime.model_mesh()


def run_mesh3d_benchmark(args):
    """The composable-parallelism scenario (bench_transformer.py's
    run_mesh3d_benchmark): returns the result dict whose ``"mesh3d"``
    sub-dict carries the reference's keys."""
    mesh = _mesh3d_runtime(args)
    device = runtime.device()
    n = runtime.size()
    ep = runtime.expert_parallel_size()
    mp = runtime.model_parallel_size()
    data_shards = n // mp  # batch shards: data x expert
    cfg = tfm.TransformerConfig(
        vocab_size=args.mesh3d_vocab, d_model=args.mesh3d_d_model,
        n_heads=4, n_kv_heads=None, n_layers=args.mesh3d_layers,
        d_ff=4 * args.mesh3d_d_model, max_seq=args.mesh3d_seq,
        dtype=torch.float32, positional="rope", attention_impl="dense",
        moe_layers=(args.mesh3d_layers - 1,), moe_num_experts=2 * ep,
        moe_top_k=2)
    axes = tfm.ShardAxes(tp=mesh.get_group("model"),
                         ep=mesh.get_group("ep"))
    specs = tfm.param_specs(cfg)
    model_keys = tfm.model_parallel_keys(cfg)
    expert_keys = ("moe.w1", "moe.w2")
    full = tfm.init_params(cfg, torch.Generator().manual_seed(0), device)

    batch, seq = args.mesh3d_batch, args.mesh3d_seq
    if batch % data_shards:
        raise ValueError(f"--mesh3d-batch {batch} not divisible by "
                         f"{data_shards} (data x expert shards)")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    targets = torch.roll(tokens, -1, dims=1)
    # this rank's batch shard: row-major over (data, expert), the same
    # on every rank of a model group
    shard = runtime.rank() // mp
    rows = slice(shard * batch // data_shards,
                 (shard + 1) * batch // data_shards)
    tokens, targets = tokens[rows].to(device), targets[rows].to(device)

    def make_step(zero_stage):
        model = tfm.TransformerLM(
            cfg, tfm.slice_param_shards(full, specs, mesh), device=device,
            axes=axes)
        opt = optimizers.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05),
            named_parameters=model.named_parameters(),
            expert_keys=expert_keys, model_keys=model_keys,
            zero_stage=zero_stage)
        step = compiled_train_step(model.loss, opt,
                                   name=f"bench.mesh3d.z{zero_stage}")
        assert step._exchange == "spec", step._exchange
        return model, opt, step

    def train(step, steps):
        for _ in range(steps):
            loss = step(tokens, targets)
        float(loss)
        return loss

    # Parity leg: the same spec without striping, 5 steps from the same
    # init.
    model2, combo, step = make_step(zero_stage=2)
    model0, _, step0 = make_step(zero_stage=0)
    train(step, 5)
    train(step0, 5)
    parity = max(float((a - b).abs().max()) for a, b in
                 zip(model2.parameters(), model0.parameters()))
    parity = _max_over_ranks(parity, device)

    train(step, 2)  # untimed
    h0, m0 = step.cache_hits, step.cache_misses
    tok_per_chip = batch * seq // n
    iters = max(args.iters, 8)
    rates = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(step(tokens, targets))  # the barrier: read on the host
        rates.append(tok_per_chip / (time.perf_counter() - t0))
    mean = float(np.mean(rates))
    conf = float(1.96 * np.std(rates))
    hits = step.cache_hits - h0
    misses = step.cache_misses - m0
    hit_rate = hits / max(hits + misses, 1)
    kinds = [combo._spec.kind(name) for name, _ in
             tfm._named_leaves(full)]
    spec_leaves = {k: kinds.count(k) for k in ("dense", "expert", "model")}
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    print(f"# 3-D mesh tokens/sec per chip: {mean:,.0f} +-{conf:,.0f} at "
          f"mesh {shape} (zero2 + moe + TP in one step), parity vs "
          f"unstriped {parity:.2e}, cache hit rate {hit_rate:.2f}, "
          f"fallbacks {step.fallback_steps}", file=sys.stderr)
    return {
        "metric": "mesh3d_tokens_per_sec_per_chip",
        "value": round(mean, 1),
        "unit": "tokens/sec",
        "mesh3d": {
            "tokens_per_sec_per_chip": round(mean, 1),
            "spread": round(conf, 1),
            "mesh_shape": {k: int(v) for k, v in shape.items()},
            "expert_parallel": ep,
            "model_parallel": mp,
            "zero_stage": 2,
            "spec_leaves": spec_leaves,
            "model_keys": len(model_keys),
            "zero2_parity_max_delta": parity,
            "parity_steps": 5,
            "global_batch": batch,
            "seq_len": seq,
            "d_model": cfg.d_model,
            "layers": cfg.n_layers,
            "moe_layers": list(cfg.moe_layers),
            "num_experts": cfg.moe_num_experts,
            "step_program_cache_hit_rate": round(hit_rate, 4),
            "step_program_cache_hits": hits,
            "step_program_cache_misses": misses,
            "fallback_steps": step.fallback_steps,
            "steps": iters,
        },
    }


def _max_over_ranks(x, device):
    """The largest of every rank's ``x``."""
    t = torch.tensor(float(x), device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return float(t)


TRACE_STEPS = 4  # steps a bench's phase trace captures


def trace_window(run_step, trace_n=TRACE_STEPS, out_dir=None):
    """Trace ``trace_n`` steps of ``run_step()`` (which runs one step and
    waits for it) with ``hvd.trace_steps``, after a bench's timed loop,
    as bench.py does: ``trace_n + 2`` steps, the first starting the
    capture and one spare so the stop fires. Returns ``(summary,
    capture dir, phase ms a step)``; the capture lands under
    ``HOROVOD_DIAG_DIR`` or a fresh temporary directory. A step that
    does not tick the tracer itself (an eager loop) ticks it here."""
    import tempfile

    from ..diag import xla_trace
    out_base = out_dir or config_mod.Config.from_env().diag_dir \
        or tempfile.mkdtemp(prefix="bench-xla-trace-")
    tracer = xla_trace.trace_steps(trace_n, out_dir=out_base)
    for _ in range(trace_n + 2):
        tracer.tick(owner=trace_window)
        run_step()
    if tracer.active or tracer.armed:
        tracer.stop()
    summary = tracer.last_summary
    phase_ms = None
    if summary:
        per = 1e3 / trace_n / max(summary["lanes"], 1)
        phase_ms = {p: round(v * per, 3)
                    for p, v in summary["phases"].items()}
    return summary, tracer.last_dir, phase_ms


class _MoEBench(torch.nn.Module):
    """The MoE layer of the scenario and its loss, mean((y - target)^2)
    + 0.01 aux, over this rank's expert group."""

    def __init__(self, params, cfg, group, chunks):
        super().__init__()
        self.moe = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v) for k, v in params.items()})
        self.cfg, self.group, self.chunks = cfg, group, chunks

    def forward(self, x, with_stats=False):
        return moe_lib.moe_layer(dict(self.moe.items()), x, self.cfg,
                                 ep_group=self.group, chunks=self.chunks,
                                 with_stats=with_stats)

    def loss(self, x, target):
        y, aux = self(x)
        return torch.mean((y - target) ** 2) + 0.01 * aux


def run_moe_benchmark(args):
    """The expert-parallel MoE scenario (bench_transformer.py's
    run_moe_benchmark): returns the result dict whose ``"moe"`` sub-dict
    carries the reference's keys."""
    runtime.init(device=args.device)
    if args.expert_parallel > 1 and runtime.expert_parallel_size() == 1:
        # up on the flat group: re-init with the 2-D (data, expert) layout
        runtime.shutdown()
        os.environ["HOROVOD_EXPERT_PARALLEL"] = str(args.expert_parallel)
        runtime.init(device=args.device)
    device = runtime.device()
    cuda = device.type == "cuda"
    ep = runtime.expert_parallel_size()
    n = runtime.size()
    group = runtime.expert_mesh().get_group("ep") if ep > 1 else None
    chunks = max(1, args.moe_chunks)
    cfg = moe_lib.MoEConfig(
        d_model=args.moe_d_model, d_ff=args.moe_d_ff,
        num_experts=args.moe_experts, top_k=2,
        capacity_factor=args.moe_capacity_factor, dtype=torch.float32)
    full = moe_lib.init_moe_params(cfg, torch.Generator().manual_seed(0),
                                   device)
    model = _MoEBench(moe_lib.expert_slice(full, runtime.rank() % ep, ep),
                      cfg, group, chunks)
    opt = optimizers.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters(), expert_keys=("w1", "w2"))
    step = compiled_train_step(model.loss, opt, name="bench.moe")

    batch, seq = args.moe_batch, args.moe_seq
    if batch % n:
        raise ValueError(f"--moe-batch {batch} not divisible by {n}")
    gen = torch.Generator().manual_seed(1 + runtime.rank())
    x, y = (torch.randn(batch // n, seq, cfg.d_model, generator=gen)
            .to(device) for _ in range(2))

    for _ in range(2):  # untimed: the first call captures
        loss = step(x, y)
    float(loss)
    h0, m0 = step.cache_hits, step.cache_misses
    tok_per_chip = batch * seq // n
    iters = max(args.iters, 8)
    rates = []
    for _ in range(iters):
        t0 = time.perf_counter()
        loss = step(x, y)
        float(loss)  # the barrier: the loss is read on the host
        rates.append(tok_per_chip / (time.perf_counter() - t0))
    mean = float(np.mean(rates))
    conf = float(1.96 * np.std(rates))
    hits = step.cache_hits - h0
    misses = step.cache_misses - m0
    hit_rate = hits / max(hits + misses, 1)

    # Routing accounting from one with_stats evaluation of the same
    # layer, summed over the ranks (the load-balance loss averaged), so
    # every rank reports the same global numbers.
    with torch.no_grad():
        _, _, st = model(x, with_stats=True)
    routed = float(allreduce(st["routed_tokens"], average=False))
    dropped = float(allreduce(st["dropped_tokens"], average=False))
    lb = float(allreduce(st["load_balance_loss"]))
    chunks_used = int(st["chunks"])
    drop_frac = dropped / max(routed + dropped, 1.0)
    metrics.record_moe_step(routed, dropped, lb, chunks_used)
    card = hardware.card_line(device.index or 0) if cuda else None
    print(f"# MoE tokens/sec per chip on {card or 'cpu'}: {mean:,.0f} "
          f"+-{conf:,.0f} at E={cfg.num_experts} ep={ep} "
          f"chunks={chunks_used}, drop_frac {drop_frac:.4f}, cache hit "
          f"rate {hit_rate:.2f}, fallbacks {step.fallback_steps}",
          file=sys.stderr)
    # Phase-attributed trace of the same step, after the timed loop:
    # the all-to-all's time and the share of it the chunked pipeline
    # hides under the expert FFN (None where none ran).
    def one_step():
        float(step(x, y))

    summary, trace_dir, phase_ms = trace_window(one_step)
    moe_trace = (summary or {}).get("moe")
    a2a_ms = hidden_frac = None
    if moe_trace:
        per = 1e3 / TRACE_STEPS / max(summary["lanes"], 1)
        a2a_ms = round(moe_trace["alltoall_s"] * per, 3)
        hidden_frac = round(moe_trace["hidden_frac"], 4)
        metrics.MOE_ALLTOALL_HIDDEN_FRAC.set(hidden_frac)
    return {
        "metric": "moe_tokens_per_sec_per_chip",
        "value": round(mean, 1),
        "unit": "tokens/sec",
        "moe": {
            "tokens_per_sec_per_chip": round(mean, 1),
            "spread": round(conf, 1),
            "alltoall_ms_per_step": a2a_ms,
            "alltoall_hidden_frac": hidden_frac,
            "drop_fraction": round(drop_frac, 4),
            "routed_tokens": routed,
            "dropped_tokens": dropped,
            "load_balance_loss": round(lb, 4),
            "num_experts": cfg.num_experts,
            "expert_parallel": ep,
            "moe_chunks": chunks_used,
            "capacity_factor": cfg.capacity_factor,
            "top_k": cfg.top_k,
            "batch_per_chip": batch // n,
            "seq_len": seq,
            "d_model": cfg.d_model,
            "d_ff": cfg.d_ff,
            "step_program_cache_hit_rate": round(hit_rate, 4),
            "step_program_cache_hits": hits,
            "step_program_cache_misses": misses,
            "fallback_steps": step.fallback_steps,
            "step_phase_breakdown": phase_ms,
            "xla_trace_dir": trace_dir,
            "steps": iters,
            "card": card,
        },
    }


def main(argv=None):
    # the bench's own timers are its output: no profiler.txt in the cwd
    # unless HOROVOD_PROFILER_PATH / _DISABLE say otherwise
    os.environ.setdefault("HOROVOD_PROFILER_DISABLE", "1")  # hvdlint: disable=HVD003 -- sets the knob's default for this process before init, which reads it through Config
    args = parse_args(argv)
    if args.serve:
        result = run_serve_benchmark(args)
    elif args.mesh3d:
        result = run_mesh3d_benchmark(args)
    elif args.moe:
        result = run_moe_benchmark(args)
    else:
        result = run_benchmark(args)
    runtime.shutdown()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
