"""``verdict_wait_ms`` (layer: serving, the settle of a dispatch's
verdicts): the program's ``verdicts.wait`` spans, the wait for the
event behind the verdicts' copy to the host, ms a step over the
window's spans."""

from portbench import ranges


def read(ctx):
    return ranges.mean_ms(ctx, "verdicts.wait")
