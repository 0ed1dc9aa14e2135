"""Plain reference of the flagship LM's training: forward, loss,
gradients, the capacity-routed top-k MoE layer, AdamW's update and, over
several ranks, the mean of the ranks' gradients.

Plain PyTorch in float32 with TF32 off, written for the benchmark from
the model's equations, computed in blocks so that it fits beside
nothing else on one card: each layer under a checkpoint, attention one
sequence at a time, the head and cross entropy one sequence chunk at a
time. It imports nothing of the program and takes nothing the program
made: weights and batches come from the seed, as the program's did.

The model (per layer, pre-norm, no biases):

    h = rmsnorm(x) * ln1;  q = h Wq, [k, v] = h Wkv  (GQA: query head j
    reads kv head j // (H / H_kv));  rope on q and k (half-split,
    theta 10000);  x += causal_softmax(q k^T / sqrt(D)) v Wo
    h = rmsnorm(x) * ln2;  x += gelu_tanh(h W1) W2, or the MoE layer

The MoE layer routes each token to its ``moe_top_k`` most probable
experts (f32 router softmax; a stable descending sort, ties to the lower
index), renormalises the k gates, and gives each expert
``ceil(t * k * capacity_factor / E)`` slots, filled in token order, every
token's first choice before any second choice; an assignment past the
capacity is dropped. Its output is the gate-weighted sum of the kept
experts' FFNs; its aux loss is Switch's ``E * sum_e(frac_e *
mean_prob_e)`` with ``frac_e`` the kept assignments per token. The loss
is the mean next-token cross entropy plus ``moe_aux_coef`` times the
summed aux losses.

``fmt`` rounds the operands of every matrix product, forward and
backward, before an f32 product: ``"f32"`` leaves them (the reference),
``"bf16"`` rounds them to bfloat16 (the precision the configuration
states), ``"fp8"`` to float8 e4m3 with a per-tensor scale (the control,
the precision below it).
"""

import math
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FORMATS = ("f32", "bf16", "fp8")
FP8_MAX = 448.0  # the largest float8 e4m3 value


def exact():
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _rounder(fmt):
    if fmt == "bf16":
        return lambda x: x.to(torch.bfloat16).float()
    if fmt == "fp8":
        def fp8(x):
            scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        return fp8
    raise ValueError(f"unknown product format {fmt!r}; one of {FORMATS}")


def _sum_to(x, shape):
    while x.dim() > len(shape):
        x = x.sum(0)
    return x


class _Product(torch.autograd.Function):
    """``a @ b`` on rounded operands, whose backward products round
    theirs too."""

    @staticmethod
    def forward(ctx, a, b, fmt):
        ctx.save_for_backward(a, b)
        ctx.fmt = fmt
        r = _rounder(fmt)
        return r(a) @ r(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = _rounder(ctx.fmt)
        g = r(g)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _sum_to(g @ r(b).transpose(-1, -2), a.shape)
        if ctx.needs_input_grad[1]:
            gb = _sum_to(r(a).transpose(-1, -2) @ g, b.shape)
        return ga, gb, None


def product(a, b, fmt):
    return a @ b if fmt == "f32" else _Product.apply(a, b, fmt)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (B, S, H, D) rotated at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, fmt):
    """Causal attention, one sequence at a time: q (B, S, H, D), k and v
    (B, S, H_kv, D)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    out = []
    for i in range(b):
        qi = q[i].transpose(0, 1)
        ki = k[i].repeat_interleave(rep, dim=1).transpose(0, 1)
        vi = v[i].repeat_interleave(rep, dim=1).transpose(0, 1)
        scores = product(qi, ki.transpose(-1, -2), fmt) / math.sqrt(d)
        p = torch.softmax(scores.masked_fill(~keep, -math.inf), dim=-1)
        out.append(product(p, vi, fmt).transpose(0, 1))
    return torch.stack(out)


def ffn(z, w1, w2, fmt):
    return product(F.gelu(product(z, w1, fmt), approximate="tanh"), w2, fmt)


def moe(h, p, cfg, fmt):
    """The MoE layer on h (B, S, d): (output, aux loss)."""
    b, s, d = h.shape
    t, e, k = b * s, cfg["moe_num_experts"], cfg["moe_top_k"]
    hf = h.reshape(t, d)
    probs = torch.softmax(product(hf, p["w_router"], fmt), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = max(1, math.ceil(t * k * cfg["moe_capacity_factor"] / e))
    taken = torch.zeros(e, dtype=torch.int64, device=h.device)
    kept = []
    for j in range(k):
        onehot = F.one_hot(idx[:, j], e)
        queue = torch.cumsum(onehot, dim=0) - 1 + taken
        taken = taken + onehot.sum(0)
        kept.append(queue.gather(1, idx[:, j, None])[:, 0] < cap)
    kept = torch.stack(kept, dim=1)
    y = torch.zeros_like(hf)
    for x in range(e):
        tok, slot = ((idx == x) & kept).nonzero(as_tuple=True)
        if tok.numel():
            out = ffn(hf[tok], p["w1"][x], p["w2"][x], fmt)
            y = y.index_add(0, tok, gates[tok, slot, None] * out)
    frac = (F.one_hot(idx, e) * kept[..., None]).sum((0, 1)).float() / t
    return y.view(b, s, d), e * torch.sum(frac * probs.mean(0))


def layer(x, p, cfg, fmt):
    b, s, d = x.shape
    h_q, h_kv = cfg["n_heads"], cfg["n_kv_heads"]
    hd = d // h_q
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    h = rmsnorm(x, p["ln1"], eps)
    q = product(h, p["wq"].reshape(d, -1), fmt).view(b, s, h_q, hd)
    kv = product(h, p["wkv"].reshape(d, -1), fmt).view(b, s, 2, h_kv, hd)
    a = attention(rope(q, theta), rope(kv[:, :, 0], theta), kv[:, :, 1], fmt)
    x = x + product(a.reshape(b, s, d), p["wo"].reshape(d, d), fmt)
    h = rmsnorm(x, p["ln2"], eps)
    if "moe" in p:
        y, aux = moe(h, p["moe"], cfg, fmt)
    else:
        y, aux = ffn(h, p["w1"], p["w2"], fmt), x.new_zeros(())
    return x + y, aux


def _chunk_nll(h, lm_head, targets, fmt):
    logits = product(h, lm_head, fmt)
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, targets[..., None])[..., 0]).sum()


def loss(params, tokens, targets, cfg, fmt="f32"):
    """Mean next-token cross entropy of ``tokens`` (B, S) plus the MoE
    aux losses, from the parameter tree ``params``."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    aux = x.new_zeros(())
    for p in params["layers"]:
        x, a = checkpoint(layer, x, p, cfg, fmt, use_reentrant=False)
        aux = aux + a
    h = rmsnorm(x, params["ln_f"], cfg["norm_eps"])
    chunk = cfg.get("loss_chunk") or s
    nll = x.new_zeros(())
    for c in range(0, s, chunk):
        nll = nll + checkpoint(_chunk_nll, h[:, c:c + chunk],
                               params["lm_head"], targets[:, c:c + chunk],
                               fmt, use_reentrant=False)
    return nll / (b * s) + cfg["moe_aux_coef"] * aux


def adamw(p, g, m, v, t, opt):
    """One step of torch's AdamW (decoupled weight decay), in place."""
    b1, b2 = opt["betas"]
    p.mul_(1.0 - opt["lr"] * opt["weight_decay"])
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    denom = (v.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(opt["eps"])
    p.addcdiv_(m, denom, value=-opt["lr"] / (1.0 - b1 ** t))


def rank_step(params, tree_of, batch, cfg, fmt, rows, device):
    """One rank's loss and gradients at ``params`` (``{leaf: tensor}``,
    copied to ``device``) on ``batch``: ``(loss, {leaf: gradient})``."""
    leaves = {k: v.detach().to(device, copy=True).requires_grad_()
              for k, v in params.items()}
    x, y = (t.to(device)[:rows] for t in batch)
    value = loss(tree_of(leaves), x, y, cfg, fmt)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return float(value.detach()), dict(zip(leaves, grads))


def train(named, tree_of, data, cfg, opt, fmt="f32", average=True,
          rows=None, devices=None):
    """Follow the program's first steps.

    ``named``: ``{leaf: tensor}`` of the initial weights (consumed);
    ``tree_of(named)`` builds the tree :func:`loss` takes; ``data``:
    one list a rank of ``(tokens, targets)`` a step. With ``average``
    every rank steps on the mean of the ranks' gradients (one
    trajectory); without, each rank on its own. ``rows`` keeps only the
    first ``rows`` sequences of each batch. The ranks' forward and
    backward passes run side by side, rank r on ``devices[r % n]`` (a
    thread each; default: the weights' device); their gradients are
    summed, in rank order, and the update made on the weights' device.
    Returns ``{"losses": [[loss a step] a rank], "grad_norms": [{leaf:
    norm of the first gradient stepped on}] a rank, "grad2_norms": the
    same of the second, "change_norms": [{leaf: norm of the change
    after the last step}] a rank}``."""
    exact()
    ranks = len(data)
    home = next(iter(named.values())).device
    devices = list(devices or [home])
    start = {k: v.detach().clone() for k, v in named.items()}
    tracks = [{k: v.detach().clone() for k, v in named.items()}
              for _ in range(1 if average else ranks)]
    named.clear()
    moments = [{k: (torch.zeros_like(v), torch.zeros_like(v))
                for k, v in tr.items()} for tr in tracks]
    losses = [[] for _ in range(ranks)]
    first = [None] * len(tracks)
    second = [None] * len(tracks)
    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        for t in range(1, len(data[0]) + 1):
            jobs = [pool.submit(rank_step, tracks[0 if average else r],
                                tree_of, data[r][t - 1], cfg, fmt, rows,
                                devices[r % len(devices)])
                    for r in range(ranks)]
            total = [None] * len(tracks)
            for r, job in enumerate(jobs):
                value, grads = job.result()
                losses[r].append(value)
                i = 0 if average else r
                if total[i] is None:
                    total[i] = {k: g.to(home) for k, g in grads.items()}
                else:
                    for k, g in grads.items():
                        total[i][k].add_(g.to(home))
                del grads
            with torch.no_grad():
                for i, tr in enumerate(tracks):
                    scale = 1.0 / ranks if average else 1.0
                    for k, p in tr.items():
                        adamw(p, total[i][k].mul_(scale), *moments[i][k], t,
                              opt)
                    norms = first if first[i] is None else second
                    if norms[i] is None:
                        norms[i] = {k: float(total[i][k].norm()) for k in tr}
    changes = [{k: float((tr[k] - start[k]).norm()) for k in tr}
               for tr in tracks]
    if average:
        first, second, changes = first * ranks, second * ranks, changes * ranks
    return {"losses": losses, "grad_norms": first, "grad2_norms": second,
            "change_norms": changes}
