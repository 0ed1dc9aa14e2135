"""Entry ``eager_hooks``: the loop users write under ``horovodrun``.

    hvd.broadcast_parameters(lm.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(lm.parameters()))
    opt.zero_grad(); loss = lm.loss(x, y); loss.backward(); opt.step()

The optimizer's gradient hooks all-reduce fused buckets during the
backward. The loop opens the phase ranges around its own calls
(``hvd_forward``, ``hvd_backward``, ``hvd_optimizer``); the exchange
opens ``hvd_exchange`` itself. It does not tick the phase tracer: the
harness does, once a step.
"""

import torch
from torch.profiler import record_function

TICKS_TRACER = False


def build(hvd, model, opt):
    """``(step, optimizer)``: ``step(tokens, targets)`` runs one training
    step and returns its loss on the device."""
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=opt["lr"],
                          betas=tuple(opt["betas"]), eps=opt["eps"],
                          weight_decay=opt["weight_decay"]),
        named_parameters=model.named_parameters())

    def step(tokens, targets):
        optimizer.zero_grad(set_to_none=True)
        with record_function("hvd_forward"):
            loss = model.loss(tokens, targets)
        with record_function("hvd_backward"):
            loss.backward()
        with record_function("hvd_optimizer"):
            optimizer.step()
        return loss.detach()

    return step, optimizer
