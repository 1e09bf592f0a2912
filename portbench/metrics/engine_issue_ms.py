"""``engine_issue_ms`` (layer: runtime, ``Sentinel``'s issue of the
engine step's operations, the single-dispatch epilogue with them): the
program's ``dispatch.engine`` spans, ms a step over the window's
spans."""

from portbench import ranges


def read(ctx):
    return ranges.mean_ms(ctx, "dispatch.engine")
