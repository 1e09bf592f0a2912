"""``stage_ms`` (layer: runtime, ``Sentinel``'s staging: the entry and
exit columns padded, pinned and copied to the device): the program's
``dispatch.stage`` spans, ms a step over the window's spans."""

from portbench import ranges


def read(ctx):
    return ranges.mean_ms(ctx, "dispatch.stage")
