"""``exchange_exposed_ms``: device milliseconds a step of the gradient
exchange during which no device event of another phase runs on any
stream: each event of an eager step joined to the innermost ``hvd_``
range around its launch, the exchange's intervals less their overlap
with the union of all the others'. A replayed graph launches its
kernels from one call, so this reads nothing there."""

from yardstick import kineto


def read(ctx):
    if not ctx.window or any(str(e.get("name", "")).startswith(
            ("cudaGraphLaunch", "cuGraphLaunch")) for e in ctx.events):
        return None
    attributed = kineto.phases_by_launch(ctx.events)
    if not any(p == "exchange" for p, _, _ in attributed):
        return None
    return kineto.exposed(attributed, "exchange") * 1e3 / ctx.steps
