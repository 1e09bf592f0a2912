"""Custom command handlers on the PyTorch port — the
``sentinel-demo-command-handler`` analog.

The reference registers user ``CommandHandler``s through SPI
(``@CommandMapping(name=...)``); here any callable registers into the
:class:`CommandCenter` and is served by the same HTTP command frontend the
dashboard talks to (port 8719 family).

Run: ``PYTHONPATH=. python demos/torch/command_handler_spi.py``
(``--device cpu`` without a GPU). The output is the same as
``demos/command_handler_spi.py``'s.
"""

import argparse
import json
import sys
import urllib.request

import torch

import sentinel_tpu_torch as stt
from sentinel_tpu_torch.core.clock import ManualClock
from sentinel_tpu_torch.transport.command import (
    CommandCenter, CommandRequest, CommandResponse,
)
from sentinel_tpu_torch.transport.handlers import register_default_handlers
from sentinel_tpu_torch.transport.http_server import SimpleHttpCommandCenter


def parse_device(argv):
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
    clk = ManualClock(start_ms=1_700_000_000_000)
    sph = stt.Sentinel(stt.load_config(
        max_resources=64, max_flow_rules=16, max_degrade_rules=16,
        max_authority_rules=16), clock=clk, device=device)
    center = CommandCenter()
    register_default_handlers(center, sph)

    # --- the custom handler: echo + live block-rate summary ---
    def block_rate(request: CommandRequest) -> CommandResponse:
        resource = request.parameters.get("resource", "")
        t = sph.node_totals(resource)
        total = t["pass"] + t["block"]
        rate = (t["block"] / total) if total else 0.0
        return CommandResponse.of_success(json.dumps(
            {"resource": resource, "blockRate": round(rate, 3)}))

    center.register(block_rate, name="blockRate")

    http = SimpleHttpCommandCenter(center, host="127.0.0.1", port=0)
    port = http.start()
    try:
        sph.load_flow_rules([stt.FlowRule(resource="pay", count=2)])
        for _ in range(10):
            try:
                with sph.entry("pay"):
                    pass
            except stt.BlockException:
                pass
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/blockRate?resource=pay") as r:
            print("custom command response:", r.read().decode())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api") as r:
            listed = r.read().decode()
        print("registered in /api listing:", "blockRate" in listed)
    finally:
        http.stop()
    return sph


if __name__ == "__main__":
    main()
