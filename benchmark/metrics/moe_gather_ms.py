"""``moe_gather_ms``: device milliseconds a step of the index gathers
and of their backward scatters: the MoE layers' dispatch gather (tokens
into capacity slots) and combine gather (each token's expert rows), with
the embedding's, whose share is a few milliseconds. On one chip the
program's ``hvd_dispatch`` range wraps the all-to-all alone, which does
not run there, so the gathers are found by their kernels' names (the
list below: PyTorch's index, gather and scatter kernels, forward and
backward)."""

import re

from yardstick import kineto

NAMES = re.compile(r"indexing_backward_kernel|index_elementwise_kernel"
                   r"|vectorized_gather_kernel|scatter_gather_elementwise"
                   r"|index_put|indexSelect|embedding_backward")


def read(ctx):
    sec = kineto.matching_time(ctx.events, NAMES)
    return sec * 1e3 / ctx.steps if sec > 0 else None
