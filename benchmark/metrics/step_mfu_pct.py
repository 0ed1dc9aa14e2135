"""``step_mfu_pct``: the whole traced window's share of the card's bf16
peak: the analytic model FLOPs of its steps (``arith.flops_per_token``)
over the window's length. It bounds every kernel's roofline share."""

from yardstick import arith


def read(ctx):
    if not ctx.window_s:
        return None
    flops = arith.flops_per_token(ctx.cfg, ctx.seq) * ctx.tokens_per_step
    return 100.0 * flops * ctx.steps / ctx.window_s / ctx.peaks["bf16_flops"]
