"""``route_ms`` (layer: runtime, ``Sentinel``'s route choice: the valid
mask, the batch's facts, the alt-row scans, route and flags): the
program's ``dispatch.route`` spans, ms a step over the window's spans."""

from portbench import ranges


def read(ctx):
    return ranges.mean_ms(ctx, "dispatch.route")
