"""``peak_mem_gib``: the most the program had allocated on the card from
its first step to the end of the timed window
(``torch.cuda.max_memory_allocated`` after a reset before the first
step: the eager first step, the capture, whose blocks in the graph's
private pool count as allocated, and every replay); over several chips,
the fullest. Blocks the allocator caches but holds for nothing do not
count."""

COMBINE = "max"


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
