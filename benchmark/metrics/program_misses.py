"""``program_misses``: the program cache's misses plus the compiled
step's fallbacks to the eager step (``hvd_step_program_cache_misses``,
``hvd_step_fallback_total``), counted over the timed window. A step
that builds or re-captures its program inside the window counts."""

COMBINE = "max"


def read(ctx):
    return ctx.program_misses
