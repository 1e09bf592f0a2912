"""Plugin discovery via the SPI loader on the PyTorch port (reference:
dropping a provider jar with ``META-INF/services`` files on the classpath
— demos ``sentinel-demo-slot-spi`` / ``sentinel-demo-command-handler``;
here the "classpath" is the SENTINEL_TPU_PLUGINS env var listing plugin
modules, and every module it names is the port's).

The plugin module below registers, purely by being imported:
* an InitFunc that loads a default flow rule at startup,
* a HostGate processor slot denying a resource,
* a custom command-plane handler.

The instance runs on a virtual clock, so the ten calls below share one
second whatever the first call costs (the reference demo reads the wall
clock: where its first call compiles for longer than the 1 s window, it
admits a sixth). Run: ``PYTHONPATH=. python demos/torch/plugin_spi.py``
(``--device cpu`` without a GPU). The output is ``demos/plugin_spi.py``'s
on a frozen clock.
"""

import argparse
import os
import sys
import tempfile
import textwrap

PLUGIN_SOURCE = textwrap.dedent('''
    """A sentinel_tpu_torch plugin: registration happens at import time."""
    from sentinel_tpu_torch.core.spi import (
        SERVICE_COMMAND_HANDLER, SERVICE_PROCESSOR_SLOT, SpiLoader, spi,
    )
    from sentinel_tpu_torch.core.initexec import init_func
    from sentinel_tpu_torch.engine.slots import HostGate

    @init_func(order=10)
    def load_default_rules(sph):
        import sentinel_tpu_torch as stt
        sph.load_flow_rules([stt.FlowRule(resource="demo", count=5.0)])

    @spi(SERVICE_PROCESSOR_SLOT, order=1)
    class MaintenanceGate(HostGate):
        name = "maintenance-gate"
        def check(self, resource, origin, acquire, args):
            return resource != "under-maintenance"

    def cmd_plugin_info(req):
        from sentinel_tpu_torch.transport.command import CommandResponse
        return CommandResponse.of_success("demo plugin v1")
    cmd_plugin_info.command_name = "pluginInfo"
    cmd_plugin_info.command_desc = "demo plugin self-description"
    SpiLoader.of(SERVICE_COMMAND_HANDLER).register(cmd_plugin_info)
''')

PLUGIN_MODULE = "demo_sentinel_torch_plugin"


def parse_device(argv):
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="engine device (default: cuda)")
    device = p.parse_args(argv).device
    if device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: this demo runs on the GPU; pass "
                 "--device cpu to run it on the CPU")
    return device


def main(argv=None):
    """Run the demo; → the ``Sentinel`` it drove."""
    device = parse_device(argv)
    with tempfile.TemporaryDirectory(prefix="stt-plugin-") as plugin_dir:
        with open(os.path.join(plugin_dir, PLUGIN_MODULE + ".py"),
                  "w") as f:
            f.write(PLUGIN_SOURCE)
        sys.path.insert(0, plugin_dir)
        os.environ["SENTINEL_TPU_PLUGINS"] = PLUGIN_MODULE
        try:
            return _drive(device)
        finally:
            sys.path.remove(plugin_dir)


def _drive(device):
    import sentinel_tpu_torch as stt
    import sentinel_tpu_torch.api as sph
    from sentinel_tpu_torch.core.clock import ManualClock
    from sentinel_tpu_torch.transport import (
        CommandCenter, CommandRequest, register_default_handlers,
    )

    inst = sph.init(stt.load_config(
        max_resources=64, max_flow_rules=8, max_degrade_rules=8,
        max_authority_rules=8),
        clock=ManualClock(start_ms=1_700_000_000_000), device=device)

    print("init-func rule loaded:",
          [r.resource for r in inst.get_flow_rules()])

    passed = blocked = 0
    for _ in range(10):
        try:
            with sph.entry("demo"):
                passed += 1
        except stt.BlockException:
            blocked += 1
    print(f"demo resource (rule from plugin init-func): "
          f"{passed} passed, {blocked} blocked")

    try:
        with sph.entry("under-maintenance"):
            pass
    except stt.CustomSlotException as exc:
        print(f"plugin slot denied: {exc.slot_name}")

    center = CommandCenter()
    register_default_handlers(center, inst)
    print("plugin command:",
          center.handle("pluginInfo", CommandRequest()).result)
    return inst


if __name__ == "__main__":
    main()
