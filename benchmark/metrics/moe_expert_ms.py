"""``moe_expert_ms``: device milliseconds a step in the MoE layers'
``hvd_expert`` range, the experts' FFN forward and backward with the
weights' casts (the phase trace's attribution)."""

from yardstick import kineto


def read(ctx):
    return kineto.phase_ms(ctx.summary, "expert", ctx.steps)
