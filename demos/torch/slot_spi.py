"""Custom processor slots on the PyTorch port — the
``sentinel-demo-slot-spi`` / ``sentinel-demo-slotchain-spi`` analog.

The reference inserts user slots into the chain via SPI
(``SlotChainProvider.java:39``, ``DefaultSlotChainBuilder.java:39``); here
user slots register against a live engine without editing it
(``Sentinel.register_slot``), in two tiers:

* a :class:`HostGate` — plain Python, vetoes before dispatch;
* a :class:`DeviceSlot` — a torch check run INSIDE the engine step on the
  engine's device, with its own state carried in the engine state.

Run: ``PYTHONPATH=. python demos/torch/slot_spi.py`` (``--device cpu``
without a GPU). The output is the same as ``demos/slot_spi.py``'s.
"""

import argparse
import sys

import torch

import sentinel_tpu_torch as stt
from sentinel_tpu_torch.core.clock import ManualClock
from sentinel_tpu_torch.engine.slots import DeviceSlot, HostGate


class PaymentGuard(HostGate):
    """Host tier: veto any entry whose first arg is a flagged account —
    the kind of bespoke business gate the reference demo's custom slot
    implements."""

    name = "payment-guard"

    def __init__(self, denylist):
        self.denylist = set(denylist)

    def check(self, resource, origin, acquire, args):
        return not (args and args[0] in self.denylist)


class EvenSecondThrottle(DeviceSlot):
    """Device tier: a (deliberately whimsical) gate that only admits
    traffic on even second-window indices, with a per-call counter in its
    own state slice — demonstrates state + a torch check with no host
    sync (``now_idx_s`` is a host int; the count stays on the device)."""

    name = "even-second-throttle"

    def init_state(self, spec):
        return torch.zeros((), dtype=torch.int32)   # total events seen

    def check(self, state, view):
        ok = (view.now_idx_s % 2) == 0
        seen = state + view.live.sum(dtype=torch.int32)
        return seen, torch.full(view.rows.shape, ok, dtype=torch.bool,
                                device=view.rows.device)


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

    sph.register_slot(PaymentGuard(denylist={"acct-666"}))
    print("== host gate ==")
    for acct in ("acct-1", "acct-666", "acct-2"):
        try:
            with sph.entry("pay", args=(acct,)):
                print(f"  {acct}: admitted")
        except stt.CustomSlotException as e:
            print(f"  {acct}: DENIED by slot {e.slot_name!r}")
    t = sph.node_totals("pay")
    print(f"  pay totals: pass={t['pass']} block={t['block']}")

    sph.register_slot(EvenSecondThrottle())
    print("== device slot (compiled into the fused step) ==")
    for step in range(4):
        try:
            with sph.entry("svc"):
                print(f"  t={step * 500}ms: admitted")
        except stt.CustomSlotException as e:
            print(f"  t={step * 500}ms: DENIED by slot {e.slot_name!r}")
        clk.advance_ms(500)
    return sph


if __name__ == "__main__":
    main()
