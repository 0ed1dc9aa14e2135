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
of the kernels, for the tests only. ``--moe`` and ``--mesh3d`` name
scenarios that are not ported yet.

``--serve`` runs the serving scenario instead (``run_serve_benchmark``,
bench_transformer.py's): the continuous-batching engine at
``--serve-streams`` concurrent streams of a small MHA model (f32, dense
attention, rope), on one card. Its bin floors pin one prefill and one
decode program (on a card, one CUDA graph each) for the run: an untimed
round builds them, the timed round reports TTFT and per-token latency
p50/p99, tokens/s and the program-cache hit rates under the serve
sub-dict's keys. Over more than one rank it raises: serving across
ranks shards the model (ROADMAP.md, Queue 1 item 6).
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import config as config_mod
from .. import hardware
from .. import optimizers, runtime
from .. import serve as hvd_serve
from ..models import transformer as tfm

ITERS = 10
STEPS_PER_ITER = 5
# optax.adamw(3e-4)'s hyperparameters (torch's AdamW defaults its weight
# decay to 1e-2; optax to 1e-4).
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
NOT_PORTED = {
    "moe": "--moe: expert parallelism is not ported yet (ROADMAP.md, "
           "Queue 1 item 7)",
    "mesh3d": "--mesh3d: tensor parallelism on the 3-D mesh is not ported "
              "yet (ROADMAP.md, Queue 1 item 6)",
}


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
                total += v.numel()
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
    ap.add_argument("--moe", action="store_true")
    ap.add_argument("--mesh3d", action="store_true")
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
    for name, why in NOT_PORTED.items():
        if getattr(args, name):
            raise NotImplementedError(why)
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
    if runtime.size() > 1:
        raise NotImplementedError(
            "--serve over more than one rank shards the model: tensor-"
            "parallel serving is not ported yet (ROADMAP.md, Queue 1 item "
            "6)")
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
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), device)
    # Bin floors pinned to the stream count: one prefill and one decode
    # signature for the whole run.
    eng = hvd_serve.Engine(
        cfg, params, num_pages=num_pages, page_size=page_size,
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


def main(argv=None):
    # the bench's own timers are its output: no profiler.txt in the cwd
    # unless HOROVOD_PROFILER_PATH / _DISABLE say otherwise
    os.environ.setdefault("HOROVOD_PROFILER_DISABLE", "1")
    args = parse_args(argv)
    result = (run_serve_benchmark(args) if args.serve
              else run_benchmark(args))
    runtime.shutdown()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
