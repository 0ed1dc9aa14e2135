"""Smoke run of horovod_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device: a CUDA card is required; its name and power limit are
   printed as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port is compiled from the checkout
   (one nvcc per source, all at once) into build/horovod_tpu_torch/;
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the same tensors on the card, at the serving prefill shape and at
   ragged, windowed, non-causal and f32 shapes, with stated tolerances;
   the kernel, the plain version and one PyTorch library call computing
   the same function are timed at the prefill shape;
4. parity: the serve engine's prefill logits through the flash kernel
   against the same prompts through ``attention_impl="dense"`` at full
   width, and a small f32 model's prefill + decode against its forward;
5. serve: the flagship transformer of bench_transformer.py at full width
   (8 layers, the bench's own depth; d_model 2048, 16 query / 4 KV heads,
   d_ff 8192, vocab 32768, rope, bf16 activations, f32 parameters,
   random weights from seed 0) serves 8 greedy requests of 512 prompt
   tokens and 64 new tokens through ``serve.Engine``, with the kernel
   launch counts zeroed just before and read just after.

The first line is the card's name and power limit as ``nvidia-smi``
gives them. The last two lines are ``{"kernels": [...]}``, one entry per
kernel of the path, and the result, ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s of
# the bf16 tensor cores and of f32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FLAGSHIP = dict(vocab_size=32768, d_model=2048, n_heads=16, n_kv_heads=4,
                n_layers=8, d_ff=8192, max_seq=4096, positional="rope")
N_REQUESTS, PROMPT_LEN, NEW_TOKENS, PAGE_SIZE = 8, 512, 64, 16

# Kernel vs plain version: f32 outputs differ by summation order only;
# a bf16 output by at most one rounding of a value below 4 (2^-6); lse
# is f32 on both sides.
F32_ATOL, BF16_ATOL, LSE_ATOL = 2e-5, 2e-2, 1e-4
# Flash vs dense prefill logits at full width (bf16 activations): the
# two attention paths round differently (dense casts p to bf16 before
# p.v; flash keeps p in f32), and 8 layers carry that into logits of
# magnitude up to ~5 (0.04 observed on an H100).
LOGITS_ATOL = 0.15
# A small f32 model: serve prefill + decode against its own forward.
SMALL_ATOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_work(b, s, h, h_kv, d, dtype, causal, window):
    """(bytes, flops) one attention forward must move and do on these
    shapes: q, k, v read once, out and the f32 lse written once; 4*D
    FLOPs per (query, key) pair the mask keeps."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * s * h * d + 2 * b * s * h_kv * d) * itemsize \
        + 4 * b * h * s
    if not causal:
        pairs = s * s
    else:
        w = s if window is None else min(window, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    return nbytes, 4 * d * pairs * b * h


def phase_kernels(fa, card, gen):
    """Kernel vs plain version at every listed shape; timings at the
    prefill shape. Returns the kernel's entry for the kernels line."""
    cases = [  # (B, S, H, H_kv, D, dtype, causal, window)
        (8, PROMPT_LEN, 16, 4, 128, torch.bfloat16, True, None),  # prefill
        (2, 1000, 16, 4, 128, torch.bfloat16, True, None),        # ragged
        (2, 1000, 16, 4, 128, torch.bfloat16, True, 256),         # window
        (2, 700, 8, 8, 64, torch.bfloat16, False, None),          # non-causal
        (2, 130, 4, 2, 8, torch.float32, True, None),             # small f32
    ]
    worst = 0.0
    entry = None
    for b, s, h, h_kv, d, dtype, causal, window in cases:
        q = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
        k = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
        v = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal,
                                                        window)
        err_o = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
        print(f"kernel flash_fwd B={b} S={s} H={h} H_kv={h_kv} D={d} "
              f"{str(dtype)[6:]} causal={causal} window={window}: "
              f"max|dO|={err_o:.3g} (tol {tol:g}) "
              f"max|dlse|={err_lse:.3g} (tol {LSE_ATOL:g})", flush=True)
        check(err_o <= tol and err_lse <= LSE_ATOL,
              f"flash_fwd disagrees with its plain version at {(b, s, h)}")
        worst = max(worst, err_o)
        if entry is not None:
            continue
        # The prefill shape: the one the main path gives the kernel.
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal, window),
                     50)
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal, window), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 50)
        nbytes, flops = attention_work(b, s, h, h_kv, d, dtype, causal,
                                       window)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        entry = {
            "name": "flash_fwd", "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "horovod_tpu/ops/flash_attention.py:72",
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": library_ms,
        }
        print(f"kernel flash_fwd timing at the prefill shape: {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
              f"{flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
    entry["max_abs_err"] = worst
    return entry


def prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, PROMPT_LEN).tolist()
            for _ in range(N_REQUESTS)]


def phase_parity(tfm, ServeEngine, params, card):
    """Full-width prefill logits through flash vs dense attention, and
    a small f32 model's serve path against its own forward."""
    ids = list(range(N_REQUESTS))
    logits = {}
    for impl in ("flash", "dense"):
        cfg = tfm.TransformerConfig(dtype=torch.bfloat16,
                                    attention_impl=impl, **FLAGSHIP)
        eng = ServeEngine(params, cfg, page_size=PAGE_SIZE, device=card)
        for sid in ids:
            eng.cache.allocate(sid, PROMPT_LEN + NEW_TOKENS)
        logits[impl] = eng.prefill(ids, prompts(cfg.vocab_size))
        del eng
    flash, dense = logits["flash"], logits["dense"]
    check(flash.shape == (N_REQUESTS, FLAGSHIP["vocab_size"])
          and np.isfinite(flash).all(), "prefill logits shape or finiteness")
    diff = float(np.abs(flash - dense).max())
    agree = float((flash.argmax(-1) == dense.argmax(-1)).mean())
    print(f"parity prefill logits flash vs dense (8 x 512, full width): "
          f"max|d|={diff:.4g} (tol {LOGITS_ATOL:g}), max|logit|="
          f"{float(np.abs(dense).max()):.3g}, argmax agreement {agree:.3f}",
          flush=True)
    check(diff <= LOGITS_ATOL, "flash and dense prefill logits disagree")

    small = tfm.TransformerConfig(
        vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=256, max_seq=64, dtype=torch.float32, positional="rope",
        attention_impl="flash")
    sp = tfm.init_params(small, torch.Generator().manual_seed(1), card)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 24))
    ref = tfm.forward(sp, torch.from_numpy(tokens).to(card), small)
    eng = ServeEngine(sp, small, num_pages=16, page_size=8, device=card)
    for sid in (0, 1):
        eng.cache.allocate(sid, 24)
    rows = [eng.prefill([0, 1], [tokens[0, :16].tolist(),
                                 tokens[1, :16].tolist()])]
    for i in range(16, 24):
        rows.append(eng.decode([0, 1], tokens[:, i], [i, i]))
    want = ref.cpu().numpy()[:, 15:24].transpose(1, 0, 2)
    small_diff = float(np.abs(np.stack(rows) - want).max())
    print(f"parity small f32 model, serve prefill+decode vs forward: "
          f"max|d|={small_diff:.3g} (tol {SMALL_ATOL:g})", flush=True)
    check(small_diff <= SMALL_ATOL, "serve path disagrees with forward")


def phase_serve(fa, serve, metrics, lm, card, where):
    """The main path: serve.Engine, 8 requests, counts zeroed around."""
    engine = serve.Engine(lm, lm.params, page_size=PAGE_SIZE,
                          max_batch=N_REQUESTS, device=card)
    try:
        warm = engine.submit(prompts(lm.cfg.vocab_size)[0], 4)
        check(len(warm.result()) == 4, "warm-up request")
        engine.batcher.recent_ttft.clear()
        engine.batcher.recent_token_latency.clear()
        prefill_hist = metrics.SERVE_STEP_SECONDS.labels(phase="prefill")
        decode_hist = metrics.SERVE_STEP_SECONDS.labels(phase="decode")
        p0, d0 = prefill_hist.value(), decode_hist.value()

        fa.launches = 0
        t0 = time.perf_counter()
        handles = [engine.submit(p, NEW_TOKENS)
                   for p in prompts(lm.cfg.vocab_size)]
        outs = [h.result() for h in handles]
        wall = time.perf_counter() - t0
        launches = fa.launches
    finally:
        engine.close()

    prefill_calls = prefill_hist.value()["count"] - p0["count"]
    decode_calls = decode_hist.value()["count"] - d0["count"]
    check(all(len(o) == NEW_TOKENS for o in outs),
          f"streams yielded {[len(o) for o in outs]} tokens")
    check(all(0 <= t < lm.cfg.vocab_size for o in outs for t in o),
          "token ids out of range")
    check(prefill_calls >= 1 and launches == lm.cfg.n_layers * prefill_calls,
          f"flash_fwd launched {launches} times over {prefill_calls} "
          f"prefill calls of {lm.cfg.n_layers} layers")
    ttft = np.asarray(engine.batcher.recent_ttft) * 1e3
    tok = np.asarray(engine.batcher.recent_token_latency) * 1e3
    generated = sum(len(o) for o in outs)
    prefill_ms = (prefill_hist.value()["sum"] - p0["sum"]) / prefill_calls \
        * 1e3
    decode_ms = (decode_hist.value()["sum"] - d0["sum"]) / decode_calls * 1e3
    print(f"serve {N_REQUESTS} x ({PROMPT_LEN} + {NEW_TOKENS}) tokens "
          f"[{where}]: ttft p50 {np.percentile(ttft, 50):.2f} ms p99 "
          f"{np.percentile(ttft, 99):.2f} ms; token latency p50 "
          f"{np.percentile(tok, 50):.2f} ms p99 {np.percentile(tok, 99):.2f}"
          f" ms; {generated / wall:.1f} tokens/s", flush=True)
    print(f"serve steps [{where}]: {prefill_calls} prefill calls, mean "
          f"{prefill_ms:.2f} ms; {decode_calls} decode steps, mean "
          f"{decode_ms:.2f} ms; flash_fwd launches {launches}", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    where = card_line()
    print(where, flush=True)
    card = torch.device("cuda")

    from horovod_tpu_torch import metrics, serve
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs) or 'up to date'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        usage = [line for line in log.splitlines()
                 if "registers" in line or "spill" in line]
        print(f"build {name}: " + " | ".join(usage), flush=True)

    gen = torch.Generator(device=card).manual_seed(0)
    entry = phase_kernels(fa, card, gen)

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **FLAGSHIP)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"model: {n_params / 1e6:.1f} M parameters (f32), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}", flush=True)
    phase_parity(tfm, ServeEngine, lm.params, card)
    entry["launches"] = phase_serve(fa, serve, metrics, lm, card, where)

    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
