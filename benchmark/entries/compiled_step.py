"""Entry ``compiled_step``: the port's compiled training step.

    step = hvd.compiled_train_step(lm.loss, hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), capturable=True)))
    loss = step(tokens, targets)

On a card its first call runs the step eagerly and captures it as a
CUDA graph; every later call replays the graph. The step ticks the
phase tracer itself.
"""

import torch

TICKS_TRACER = True


def build(hvd, model, opt):
    """``(step, optimizer)``: ``step(tokens, targets)`` runs one training
    step and returns its loss on the device. AdamW keeps its step count
    on the card (``capturable``), as a graph that advances it needs; the
    CPU, where nothing is captured, has no such mode."""
    cuda = next(model.parameters()).is_cuda
    optimizer = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=opt["lr"],
                          betas=tuple(opt["betas"]), eps=opt["eps"],
                          weight_decay=opt["weight_decay"], capturable=cuda),
        named_parameters=model.named_parameters())
    return hvd.compiled_train_step(model.loss, optimizer,
                                   name="benchmark.step"), optimizer
