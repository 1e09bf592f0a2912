"""The device time of one of the engine step's slots, read from the
traced stretch: the union of the device intervals of the kernels
launched inside the program's ranges of that name (``engine.<slot>``),
ms a traced step. A kernel belongs to the range that holds its launch
on the launching thread, matched through the trace's ``correlation``
ids. A program without such ranges gives nothing to read (None)."""

import bisect
from typing import Optional

from portbench import ranges, trace


def ms_a_step(ctx, name: str) -> Optional[float]:
    n = len(ctx.traced_steps)
    if ctx.events is None or not n:
        return None
    slots = ranges.of(ctx.events, name, ctx.lo, ctx.hi)
    if not slots or not trace.device_ops(ctx.events, ctx.lo, ctx.hi):
        return None
    by_thread = {}
    for s, t, tid in sorted(slots):
        by_thread.setdefault(tid, []).append((s, t))
    launched = set()
    for e in ctx.events:
        if e.get("cat") != "cuda_runtime" or e.get("name") not in \
                trace.LAUNCHES:
            continue
        corr = (e.get("args") or {}).get("correlation")
        rs = by_thread.get(e.get("tid"), ())
        ts = float(e["ts"])
        i = bisect.bisect_right(rs, (ts, float("inf"))) - 1
        if corr is not None and i >= 0 and rs[i][0] <= ts <= rs[i][1]:
            launched.add(corr)
    kernels = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
               for e in ctx.events if e.get("cat") == "kernel"
               and (e.get("args") or {}).get("correlation") in launched]
    ops = [(max(s, ctx.lo), min(t, ctx.hi)) for s, t in kernels
           if t > ctx.lo and s < ctx.hi]
    return trace.busy(ops) / 1e3 / n if ops else 0.0
