"""``dispatch_ms`` (layer: runtime, ``Sentinel``'s staging, route choice
and enqueue of the engine step): the program's ``fused.dispatch`` /
``decide.dispatch`` spans, ms a step over the window's spans."""


def read(ctx):
    d = [s["dur_ns"] for s in ctx.spans
         if s["name"] in ("fused.dispatch", "decide.dispatch")]
    return sum(d) / len(d) / 1e6 if d else None
