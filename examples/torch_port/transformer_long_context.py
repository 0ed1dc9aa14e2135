"""Long-context transformer training on horovod_tpu_torch: dp x sp x tp.

Counterpart of examples/transformer_long_context.py, with its flags and
defaults (d_model 512, 8 heads, 4 layers, seq 2048, vocab 32768, bf16,
AdamW 3e-4). The flagship TransformerLM with sequence parallelism over
``sp`` (ring attention, or Ulysses' all-to-all head <-> sequence
re-shard), Megatron-style tensor parallelism over ``tp`` and data
parallelism over ``dp``.

Where the reference runs all three axes in one process's ``shard_map``
over a device mesh, the port splits them: ``--sp`` runs over a local
``RingAxis`` in this process (every shard on this one device, how one
card runs the ring or Ulysses), while data parallelism runs over the
process group when the script is launched with ``python -m
horovod_tpu_torch.run -np N``, and ``--tp`` over the runtime's 3-D
(data, expert, model) mesh of those N ranks when N allows it (dp = N /
tp). ``--cpu-devices`` has no meaning in torch (the reference's virtual
XLA CPU mesh) and is dropped: pass ``--device cpu`` to run on the CPU,
where each attention kernel runs its plain PyTorch version.

On a card at the defaults the head dim is 64: ``--attention ring-flash``
sends every tile through the hand-written kernels' tensor-core route
(ops/csrc/flash_fwd.cu, flash_bwd.cu), the ring's visiting tiles through
the band kernels. The last line is a JSON summary: the losses, tokens a
second and the kernels' launches by route.

Run: python examples/torch_port/transformer_long_context.py
         [--sp N --tp N --attention ring-flash] [--device cpu]
     python -m horovod_tpu_torch.run -np 2 python
         examples/torch_port/transformer_long_context.py --tp 2
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

parser = argparse.ArgumentParser()
parser.add_argument("--dp", type=int, default=-1,
                    help="data-parallel ranks (default: the launched "
                         "ranks over --tp)")
parser.add_argument("--sp", type=int, default=1)
parser.add_argument("--tp", type=int, default=1)
parser.add_argument("--seq-len", type=int, default=2048)
parser.add_argument("--d-model", type=int, default=512)
parser.add_argument("--positional", choices=["learned", "rope"],
                    default="learned")
parser.add_argument("--generate", type=int, default=0, metavar="N",
                    help="after training, greedy-decode N tokens from a "
                         "prompt through the serve engine's paged KV "
                         "cache (single-shard configs only: --sp 1 --tp 1)")
parser.add_argument("--loss-chunk", type=int, default=None,
                    help="chunked cross entropy: compute LM head + loss "
                         "per chunk of this many positions so the "
                         "(B, S, vocab) logits never materialize")
parser.add_argument("--window", type=int, default=None,
                    help="sliding-window attention span (causal band)")
parser.add_argument("--kv-heads", type=int, default=None,
                    help="grouped-query attention: K/V head count "
                         "(default: equal to the 8 query heads)")
parser.add_argument("--layers", type=int, default=4)
parser.add_argument("--steps", type=int, default=10)
parser.add_argument("--attention",
                    choices=["ring", "ring-flash", "ulysses",
                             "ulysses-flash", "dense", "flash"],
                    default="ring",
                    help="ring[-flash] = sequence-parallel ring attention "
                         "over sp (tiles computed dense or by the "
                         "hand-written kernels); ulysses[-flash] = "
                         "all-to-all head<->sequence re-shard with dense "
                         "or flash attention; dense/flash = single-shard "
                         "attention")
parser.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
args = parser.parse_args()


def main():
    if args.tp > 1:
        # the runtime lays the launched ranks out as (dp, ep, model)
        os.environ["HOROVOD_MODEL_PARALLEL"] = str(args.tp)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.ring_attention import RingAxis

    seq_par = args.attention.startswith(("ring", "ulysses"))
    if not seq_par and args.sp != 1:
        parser.error("--attention dense/flash requires --sp 1")
    hvd.init(device=args.device)
    device = hvd.runtime.device()
    dp = hvd.size() // args.tp
    if args.dp not in (-1, dp):
        parser.error(f"--dp {args.dp} x --tp {args.tp} != {hvd.size()} "
                     "launched ranks")
    mesh = hvd.model_mesh() if args.tp > 1 else None
    axes = tfm.ShardAxes(
        sp=RingAxis.local(args.sp) if seq_par and args.sp > 1 else None,
        tp=mesh.get_group("model") if mesh is not None else None)
    if hvd.rank() == 0:
        print(f"mesh: dp={dp} sp={args.sp} tp={args.tp} ({hvd.size()} "
              f"ranks on {device}), seq={args.seq_len}", flush=True)
    cfg = tfm.TransformerConfig(
        vocab_size=32768, d_model=args.d_model, n_heads=8,
        n_layers=args.layers, d_ff=4 * args.d_model, max_seq=args.seq_len,
        dtype=torch.bfloat16,
        attention_impl="flash" if args.attention.endswith("flash")
        else "dense",
        sp_impl="ulysses" if args.attention.startswith("ulysses")
        else "ring",
        n_kv_heads=args.kv_heads, attention_window=args.window,
        loss_chunk=args.loss_chunk, positional=args.positional)
    # every rank draws the same tree (seed 0); a model group's ranks each
    # keep their shard of it
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), device)
    if mesh is not None:
        params = tfm.slice_param_shards(params, tfm.param_specs(cfg), mesh)
    lm = tfm.TransformerLM(cfg, params, device=device, axes=axes)
    if mesh is None:
        hvd.broadcast_parameters(lm.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=lm.named_parameters(),
        model_keys=tfm.model_parallel_keys(cfg) if mesh is not None
        else None)

    # a batch of 2 a data-parallel rank; a model group's ranks share it
    rng = np.random.default_rng(1 + hvd.rank() // args.tp)
    tokens = rng.integers(0, cfg.vocab_size, (2, args.seq_len))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(device)
    tokens = torch.from_numpy(tokens).to(device)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = lm.loss(tokens, targets)
        loss.backward()
        opt.step()
        return loss.detach()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # two untimed steps (the first builds the kernels and cuBLAS state),
    # as the reference runs two untimed calls before timing
    losses = [step(), step()]
    if hvd.rank() == 0:
        print(f"compiled; initial loss={float(losses[0]):.4f}", flush=True)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        losses.append(step())
    sync()
    dt = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    toks = 2 * dp * args.seq_len * args.steps / dt
    if hvd.rank() == 0:
        print(f"losses: {' '.join(f'{x:.4f}' for x in losses)}")
        print(f"loss={losses[-1]:.4f}  {toks:,.0f} tokens/sec", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    maybe_generate(lm, cfg, device)
    summary = {"example": "transformer_long_context", "rank": hvd.rank(),
               "losses": losses, "tokens_per_sec": toks,
               "head_dim": cfg.head_dim, "launches": fa.launch_counts()}
    hvd.shutdown()
    print(json.dumps(summary), flush=True)


def maybe_generate(lm, cfg, device):
    if not args.generate:
        return
    if args.sp != 1 or args.tp != 1:
        print("skipping --generate (single-shard configs only)")
        return
    from horovod_tpu_torch import serve
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 16)
    with torch.no_grad(), serve.Engine(cfg, lm.params, device=device) as eng:
        toks = list(eng.stream(eng.submit(prompt.tolist(), args.generate)))
    assert len(toks) == args.generate, toks
    print(f"generated {args.generate} tokens through the serve engine's "
          f"KV cache: {toks[:16]}{'...' if args.generate > 16 else ''}")


if __name__ == "__main__":
    main()
