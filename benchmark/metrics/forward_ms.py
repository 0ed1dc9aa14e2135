"""``forward_ms``: device milliseconds a step in the program's
``hvd_forward`` range (the phase trace's attribution of each kernel,
copy and set, ``hvd.trace_steps``), over the traced window."""

from yardstick import kineto


def read(ctx):
    return kineto.phase_ms(ctx.summary, "forward", ctx.steps)
