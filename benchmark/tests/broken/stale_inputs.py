"""The compiled step, broken in its replays alone: every step after the
first runs on the first step's batch, as a replay does whose new inputs
are never copied into the graph's own. The first call, which runs
eagerly, is sound."""

from pathlib import Path

from yardstick import spec

TICKS_TRACER = True


def build(hvd, model, opt):
    base = spec.load_module(Path(__file__).with_name("compiled_step.py"),
                             "compiled_step_base")
    step, optimizer = base.build(hvd, model, opt)
    first = []

    def stale(tokens, targets):
        if not first:
            first.append((tokens, targets))
        return step(*first[0])

    return stale, optimizer
