"""``device_ms_per_step`` (layer: engine): the union of the kernel,
memory-copy and memory-set intervals of the traced stretch, ms a
step."""

from portbench import trace


def read(ctx):
    n = len(ctx.traced_steps)
    if ctx.events is None or not n:
        return None
    ops = trace.device_ops(ctx.events, ctx.lo, ctx.hi)
    return trace.busy(ops) / 1e3 / n if ops else None
