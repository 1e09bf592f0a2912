"""``param_resolve_ms`` (layer: runtime, ``Sentinel``'s resolution of a
fused batch's call arguments into hot-parameter key rows: the pairs,
their distinct keys, the registry's interning): the program's
``dispatch.param`` spans, ms a step over the window's spans."""

from portbench import ranges


def read(ctx):
    return ranges.mean_ms(ctx, "dispatch.param")
