"""``device_idle_share`` (layer: device): the share of the traced
stretch in which no kernel, memory copy or memory set runs, in %."""

from portbench import trace


def read(ctx):
    if ctx.events is None or ctx.hi <= ctx.lo:
        return None
    ops = trace.device_ops(ctx.events, ctx.lo, ctx.hi)
    if not ops:
        return None
    return 100.0 * (1.0 - trace.busy(ops) / (ctx.hi - ctx.lo))
