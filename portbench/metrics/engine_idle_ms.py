"""``engine_idle_ms`` (layer: runtime to device): the device's idle time
inside the program's engine-issue ranges, ms a traced step: how far the
engine's op issue starves the device. The engine's issue is the region
of the program's ``dispatch.engine`` span, which the profiler sees as
the dispatch's ``sentinel_tpu.fused`` / ``sentinel_tpu.decide`` /
``sentinel_tpu.decide_split`` range. The ranges are on the profiler's
clock; the device is idle where no kernel, memory copy or memory set
runs."""

from portbench import trace
from portbench import ranges

#: the program's ranges around an engine step's issue
ENGINE = ("sentinel_tpu.fused", "sentinel_tpu.decide",
          "sentinel_tpu.decide_split")


def read(ctx):
    n = len(ctx.traced_steps)
    if ctx.events is None or not n:
        return None
    engine = [iv for name in ENGINE
              for iv in ranges.of(ctx.events, name, ctx.lo, ctx.hi)]
    ops = trace.device_ops(ctx.events, ctx.lo, ctx.hi)
    if not engine or not ops:
        return None
    idle = trace.gaps(trace.merge(ops), ctx.lo, ctx.hi)
    return ranges.overlap(idle, engine) / 1e3 / n
