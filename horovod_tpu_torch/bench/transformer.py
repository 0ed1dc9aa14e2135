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
of the kernels, for the tests only. ``--moe``, ``--mesh3d`` and
``--serve`` name scenarios that are not ported yet.
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
    "serve": "--serve: the serving bench is not ported yet (ROADMAP.md, "
             "Queue 1 item 9)",
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
    ap.add_argument("--serve", action="store_true")
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


def main(argv=None):
    # the bench's own timers are its output: no profiler.txt in the cwd
    # unless HOROVOD_PROFILER_PATH / _DISABLE say otherwise
    os.environ.setdefault("HOROVOD_PROFILER_DISABLE", "1")
    result = run_benchmark(parse_args(argv))
    runtime.shutdown()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
