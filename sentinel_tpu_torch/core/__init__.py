from sentinel_tpu_torch.core.clock import (
    Clock, ManualClock, SystemClock, global_clock, set_global_clock,
)
from sentinel_tpu_torch.core.config import SentinelConfig, load_config
from sentinel_tpu_torch.core.errors import (
    AuthorityException,
    BlockException,
    BlockReason,
    DegradeException,
    ErrorEntryFreeError,
    FlowException,
    ParamFlowException,
    SentinelError,
    SystemBlockException,
    block_exception_for,
    is_block_exception,
)
from sentinel_tpu_torch.core.registry import (
    ENTRY_NODE_NAME,
    ENTRY_NODE_ROW,
    OriginRegistry,
    Registry,
    ResourceRegistry,
)

__all__ = [
    "Clock", "ManualClock", "SystemClock", "global_clock", "set_global_clock",
    "SentinelConfig", "load_config",
    "BlockException", "BlockReason", "FlowException", "DegradeException",
    "SystemBlockException", "AuthorityException", "ParamFlowException",
    "SentinelError", "ErrorEntryFreeError", "block_exception_for", "is_block_exception",
    "Registry", "ResourceRegistry", "OriginRegistry", "ENTRY_NODE_ROW", "ENTRY_NODE_NAME",
]
