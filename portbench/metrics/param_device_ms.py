"""``param_device_ms`` (layer: engine, the param slot: the hot-parameter
checks and the key state's writeback): the union of the device intervals
of the kernels launched inside the program's ``engine.param`` ranges, ms
a traced step (:mod:`portbench.slot_device`)."""

from portbench import slot_device


def read(ctx):
    return slot_device.ms_a_step(ctx, "engine.param")
