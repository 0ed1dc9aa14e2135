"""The compiled step, broken: the loss it answers altered where it is
produced (two percent high)."""

from pathlib import Path

from yardstick import spec

TICKS_TRACER = True


def build(hvd, model, opt):
    base = spec.load_module(Path(__file__).with_name("compiled_step.py"),
                             "compiled_step_base")
    step, optimizer = base.build(hvd, model, opt)

    def altered(tokens, targets):
        return step(tokens, targets) * 1.02

    return altered, optimizer
