"""``launches_per_step`` (layer: runtime to device): the CUDA runtime's
kernel and graph launches in the traced stretch, a step."""

from portbench import trace


def read(ctx):
    n = len(ctx.traced_steps)
    if ctx.events is None or not n:
        return None
    count = trace.launches(ctx.events, ctx.lo, ctx.hi)
    return count / n if count else None
