"""The eager Horovod loop, broken: the exchange between ranks left out
(a plain AdamW, so each rank steps on its own gradient)."""

import torch
from torch.profiler import record_function

TICKS_TRACER = False


def build(hvd, model, opt):
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=opt["lr"], betas=tuple(opt["betas"]),
        eps=opt["eps"], weight_decay=opt["weight_decay"])

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
