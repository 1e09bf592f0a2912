"""``enqueue_ms`` (layer: serving, ``DispatchPipeline``): the self time
of the program's ``pipeline.enqueue`` span, its duration less the part
that the runtime's spans nested in it on its thread cover, ms a step
over the window's spans."""

import bisect
import collections

from portbench import trace


def read(ctx):
    outer = [s for s in ctx.spans if s["name"] == "pipeline.enqueue"]
    if not outer:
        return None
    by_thread = collections.defaultdict(list)
    for s in ctx.spans:
        if s["name"] != "pipeline.enqueue":
            by_thread[s["thread"]].append(s)
    starts = {}
    for t, ss in by_thread.items():
        ss.sort(key=lambda s: s["start_ns"])
        starts[t] = [s["start_ns"] for s in ss]
    total = 0.0
    for o in outer:
        ss = by_thread.get(o["thread"], [])
        st = starts.get(o["thread"], [])
        lo = bisect.bisect_left(st, o["start_ns"])
        hi = bisect.bisect_left(st, o["end_ns"])
        inner = [(s["start_ns"], min(s["end_ns"], o["end_ns"]))
                 for s in ss[lo:hi]]
        total += o["dur_ns"] - trace.busy(inner)
    return total / len(outer) / 1e6
