"""``attn_roofline_pct``: attention's least time over its device time.

The least time is the larger of its operations over the card's bf16
peak and its bytes over the card's HBM rate (``arith.attention_work``:
causal, 2 products forward and 4 backward, no recompute; each input
read and each output written once). The device time is that of the
kernels whose names the list below matches: the port's ``flash_*``
kernels and the attention kernels a library would put in their place
(cuDNN's, SDPA's, FlashAttention's), so the metric reads the same work
whatever computes it."""

import re

from yardstick import arith, kineto

NAMES = re.compile(r"flash|fmha|attention|attn|sdpa|cudnn.*mha",
                   re.IGNORECASE)


def read(ctx):
    device = kineto.matching_time(ctx.events, NAMES)
    if device <= 0:
        return None
    flops, nbytes = arith.attention_work(ctx.cfg, ctx.batch, ctx.seq)
    least = arith.least_time(flops, nbytes, ctx.peaks["bf16_flops"],
                             ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least * ctx.steps / device
