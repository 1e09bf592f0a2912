"""Pluggable processor slots: the SlotChainBuilder / ProcessorSlot SPI.

Port of ``sentinel_tpu/engine/slots.py`` (reference: custom slots plug
into the chain through ``SlotChainProvider`` / ``SpiLoader``). The chain is
one engine step, so a user's slot comes in two tiers:

* :class:`HostGate` — a check on the host before the device dispatch, on
  the single-entry and the batch tier. It denies by returning False (or by
  raising a :class:`~sentinel_tpu_torch.core.errors.BlockException`); the
  denial is recorded as a BLOCK on the device like any other and surfaces
  as :class:`~sentinel_tpu_torch.core.errors.CustomSlotException` with the
  gate's name (or as the exception the gate raised).
* :class:`DeviceSlot` — a check INSIDE the engine step, after the built-in
  cascade (authority → system → param → flow → degrade), in registration
  order, seeing only the events still live. ``check(state, view)`` is a
  function on torch tensors (on the engine's device) that returns the
  slot's next state and a bool[B] ok mask; its state (a tensor or a tuple
  of tensors) is carried in the engine state. It must not wait on the
  device (no ``.item()``, no boolean-mask indexing): the engine step runs
  without a host sync.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from sentinel_tpu_torch.core.errors import BlockException, BlockReason


class DeviceSlotView(NamedTuple):
    """Read-only per-event inputs handed to a :class:`DeviceSlot`."""

    rows: torch.Tensor          # int32[B] main resource row (>= R padding)
    origin_ids: torch.Tensor    # int32[B] (0 = none)
    acquire: torch.Tensor       # int32[B]
    is_in: torch.Tensor         # bool[B]
    prioritized: torch.Tensor   # bool[B]
    live: torch.Tensor          # bool[B]: still admitted by earlier slots
    now_idx_s: int              # second-window index
    rel_now_ms: int             # ms since the process epoch
    pass_counts: torch.Tensor   # float32[B]: rolling PASS of each event's
    # row over the second window


class DeviceSlot:
    """Base class for slots that run inside the engine step."""

    #: shown in CustomSlotException.slot_name
    name: str = "device-slot"

    def init_state(self, spec) -> Any:
        """Initial state (called at registration): a tensor, a tuple of
        tensors, or () for a stateless slot; ``spec`` is the EngineSpec.
        The runtime moves it to the engine's device."""
        return ()

    def check(self, state: Any, view: DeviceSlotView):
        """→ ``(next_state, ok bool[B])`` (torch, no host sync). Events with
        ``view.live`` False are already denied or padding: their ok value
        is ignored."""
        raise NotImplementedError


class HostGate:
    """Base class for host-side gates. Override :meth:`check` (and
    :meth:`check_batch` for the batch tier; the default loops ``check``)."""

    name: str = "host-gate"

    def check(self, resource: str, origin: str, acquire: int,
              args: Sequence) -> bool:
        """→ False to deny (or raise a BlockException subclass)."""
        return True

    def check_batch(self, resources: Sequence[str],
                    origins: Optional[Sequence[str]],
                    acquire, args_list) -> Sequence[bool]:
        out = []
        for i, r in enumerate(resources):
            org = origins[i] if origins is not None and origins[i] else ""
            args = args_list[i] if args_list is not None else ()
            try:
                ok = bool(self.check(r, org, int(acquire[i]), args))
            except BlockException:
                # the entry() tier's deny style denies just this event here
                # (the gate's reason code, not the raised class)
                ok = False
            out.append(ok)
        return out


def run_device_slots(custom_slots: Tuple[DeviceSlot, ...], custom_states,
                     view: DeviceSlotView):
    """Cascade the registered device slots → (next states tuple, combined
    ok bool[B], reason int8[B]: ``CUSTOM_BASE + position`` where a slot
    blocked, else 0)."""
    ok_all = torch.ones_like(view.live)
    reason = torch.zeros(view.rows.shape, dtype=torch.int8,
                         device=view.rows.device)
    live = view.live
    next_states = []
    for si, slot in enumerate(custom_slots):
        st2, ok = slot.check(custom_states[si], view._replace(live=live))
        ok = ok | ~live               # only live events can be denied
        next_states.append(st2)
        newly = ~ok & (reason == 0)
        reason = torch.where(newly, BlockReason.CUSTOM_BASE + si, reason
                             ).to(torch.int8)
        ok_all = ok_all & ok
        live = live & ok
    return tuple(next_states), ok_all, reason
