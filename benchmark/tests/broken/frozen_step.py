"""The compiled step, broken: it returns its state unchanged (each
step's update undone)."""

from pathlib import Path

import torch

from yardstick import spec

TICKS_TRACER = True


def build(hvd, model, opt):
    base = spec.load_module(Path(__file__).with_name("compiled_step.py"),
                             "compiled_step_base")
    step, optimizer = base.build(hvd, model, opt)
    params = list(model.parameters())

    def frozen(tokens, targets):
        held = [p.detach().clone() for p in params]
        loss = step(tokens, targets)
        with torch.no_grad():
            torch._foreach_copy_(params, held)
        return loss

    return frozen, optimizer
