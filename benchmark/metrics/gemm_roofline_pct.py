"""``gemm_roofline_pct``: the matrix products' least time over their
device time.

Operations from shapes (``arith.gemm_flops``): 2 x M x N x K of each
forward product and of its two backward products, the experts' over the
tokens routed to them (``moe_top_k`` a token), against the card's bf16
peak. The device time is that of the kernels whose names the list below
matches (cuBLAS's and CUTLASS's ``gemm``, ``xmma``, ``nvjet`` and
``cutlass`` kernels, split-K reductions), leaving out attention's."""

import re

from yardstick import arith, kineto

NAMES = re.compile(r"gemm|xmma|nvjet|cutlass|splitkreduce|cublas",
                   re.IGNORECASE)
NOT = re.compile(r"flash|fmha|attention|attn", re.IGNORECASE)


def read(ctx):
    device = kineto.matching_time(ctx.events, NAMES, NOT)
    if device <= 0:
        return None
    flops = arith.gemm_flops(ctx.cfg, ctx.tokens_per_step)
    return 100.0 * flops / ctx.peaks["bf16_flops"] * ctx.steps / device
