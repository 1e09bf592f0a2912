"""Block-exception hierarchy and verdict reason codes.

Mirrors the reference's ``BlockException`` family
(``sentinel-core/.../slots/block/*``): one subclass per rule engine, carrying
the triggering rule. The device pipeline returns an ``int8`` reason code per
event (it cannot raise), and the host runtime maps codes to these exceptions
at the API boundary, preserving ``SphU.entry`` semantics (throw on block).

The PyTorch port's own copy of ``sentinel_tpu/core/errors.py``: the codes
and class names are identical (the block log and the wire name them).
"""

from __future__ import annotations

from typing import Any, Optional


class BlockReason:
    """Verdict reason codes produced by the device pipeline (int8)."""

    NONE = 0
    FLOW = 1
    DEGRADE = 2
    SYSTEM = 3
    AUTHORITY = 4
    PARAM_FLOW = 5
    # codes >= CUSTOM_BASE are user ProcessorSlots (reference: custom slots
    # inserted via SlotChainBuilder SPI throw their own BlockException
    # subclasses). Two disjoint sub-spaces of the int8 range:
    # CUSTOM_BASE + i  = registered DeviceSlot i (emitted by the pipeline)
    # CUSTOM_GATE_BASE + i = registered HostGate i (emitted host-side)
    CUSTOM_BASE = 16
    CUSTOM_GATE_BASE = 96

    NAMES = {
        NONE: "none",
        FLOW: "FlowException",
        DEGRADE: "DegradeException",
        SYSTEM: "SystemBlockException",
        AUTHORITY: "AuthorityException",
        PARAM_FLOW: "ParamFlowException",
    }


class SentinelError(Exception):
    """Base for framework errors that are NOT flow-control verdicts."""


class ErrorEntryFreeError(SentinelError):
    """Mis-paired entry/exit (reference: ErrorEntryFreeException)."""


class BlockException(Exception):
    """A guarded call was denied. Reference: ``BlockException``."""

    reason_code = BlockReason.NONE

    def __init__(self, resource: str, rule: Optional[Any] = None,
                 origin: str = "", wait_ms: int = 0):
        self.resource = resource
        self.rule = rule
        self.origin = origin
        self.wait_ms = wait_ms
        super().__init__(f"{type(self).__name__}: resource={resource!r} origin={origin!r}")


class FlowException(BlockException):
    reason_code = BlockReason.FLOW


class DegradeException(BlockException):
    reason_code = BlockReason.DEGRADE


class SystemBlockException(BlockException):
    reason_code = BlockReason.SYSTEM


class AuthorityException(BlockException):
    reason_code = BlockReason.AUTHORITY


class ParamFlowException(BlockException):
    reason_code = BlockReason.PARAM_FLOW


class CustomSlotException(BlockException):
    """A user ProcessorSlot denied the entry. ``slot_name`` names the
    registered slot (the analog of a custom BlockException subclass from a
    slot-chain-SPI slot)."""

    reason_code = BlockReason.CUSTOM_BASE

    def __init__(self, resource: str, rule: Optional[Any] = None,
                 origin: str = "", wait_ms: int = 0, slot_name: str = ""):
        self.slot_name = slot_name
        super().__init__(resource, rule=rule, origin=origin, wait_ms=wait_ms)


_BY_CODE = {
    BlockReason.FLOW: FlowException,
    BlockReason.DEGRADE: DegradeException,
    BlockReason.SYSTEM: SystemBlockException,
    BlockReason.AUTHORITY: AuthorityException,
    BlockReason.PARAM_FLOW: ParamFlowException,
}


def exception_name_for(code: int) -> str:
    """Exception class name for a BlockReason code (block-log lines)."""
    if int(code) >= BlockReason.CUSTOM_BASE:
        return CustomSlotException.__name__
    return _BY_CODE.get(int(code), BlockException).__name__


def block_exception_for(code: int, resource: str, origin: str = "",
                        wait_ms: int = 0, rule: Optional[Any] = None,
                        slot_name: str = "") -> BlockException:
    if int(code) >= BlockReason.CUSTOM_BASE:
        return CustomSlotException(resource, rule=rule, origin=origin,
                                   wait_ms=wait_ms, slot_name=slot_name)
    cls = _BY_CODE.get(int(code), BlockException)
    return cls(resource, rule=rule, origin=origin, wait_ms=wait_ms)


def is_block_exception(exc: BaseException) -> bool:
    return isinstance(exc, BlockException)
