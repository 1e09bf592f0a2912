"""sentinel_tpu_torch: the PyTorch / CUDA port of ``sentinel_tpu``.

Flow control, circuit breaking and system protection — the capabilities of
Alibaba Sentinel — on an NVIDIA GPU (written for Hopper, ``sm_90a``). The
JAX package ``sentinel_tpu`` stays beside it as the reference that every
module here is held to, bit for bit; this package imports neither JAX nor
``sentinel_tpu``.

It ports admission end to end — the scalar, fast and general routes of
the JAX runtime, origins and entrance contexts, prioritized events
(occupy), the host fast path of the default configuration, hot-parameter
rules and user processor slots::

    import sentinel_tpu_torch as stt

    sph = stt.Sentinel(stt.load_config())   # device="cuda" by default
    sph.load_flow_rules([stt.FlowRule(resource="HelloWorld", count=20)])
    # at most 5 calls a second per user id (the call's first argument)
    sph.load_param_flow_rules([stt.ParamFlowRule(resource="HelloWorld",
                                                 param_idx=0, count=5)])
    sph.register_slot(MyGate())             # a stt.HostGate subclass
    try:
        with sph.entry("HelloWorld", origin="app-a", args=(user_id,)):
            do_something()
        # may borrow the next window's budget and wait for its edge
        with sph.entry("HelloWorld", prioritized=True):
            do_something()
    except stt.BlockException:
        do_fallback()
"""

from sentinel_tpu_torch.core.clock import (
    Clock, ManualClock, SystemClock, set_global_clock,
)
from sentinel_tpu_torch.core.config import SentinelConfig, load_config
from sentinel_tpu_torch.core.errors import (
    AuthorityException,
    BlockException,
    BlockReason,
    CustomSlotException,
    DegradeException,
    ErrorEntryFreeError,
    FlowException,
    ParamFlowException,
    SystemBlockException,
)
from sentinel_tpu_torch.engine.slots import (
    DeviceSlot, DeviceSlotView, HostGate,
)
from sentinel_tpu_torch.rules.authority import (
    STRATEGY_BLACK, STRATEGY_WHITE, AuthorityRule,
)
from sentinel_tpu_torch.rules.degrade import (
    GRADE_EXCEPTION_COUNT,
    GRADE_EXCEPTION_RATIO,
    GRADE_RT,
    DegradeRule,
)
from sentinel_tpu_torch.rules.flow import (
    BEHAVIOR_DEFAULT,
    BEHAVIOR_RATE_LIMITER,
    BEHAVIOR_WARM_UP,
    BEHAVIOR_WARM_UP_RATE_LIMITER,
    GRADE_QPS,
    GRADE_THREAD,
    STRATEGY_CHAIN,
    STRATEGY_DIRECT,
    STRATEGY_RELATE,
    FlowRule,
)
from sentinel_tpu_torch.rules.param_flow import (
    BEHAVIOR_RATE_LIMITER as PARAM_BEHAVIOR_RATE_LIMITER,
    ParamFlowItem,
    ParamFlowRule,
)
from sentinel_tpu_torch.rules.system import SystemRule
from sentinel_tpu_torch.runtime import (
    ENTRY_TYPE_IN, ENTRY_TYPE_OUT, Entry, PendingVerdicts, Sentinel,
)

__version__ = "0.1.0"

__all__ = [
    "Sentinel", "Entry", "PendingVerdicts", "ENTRY_TYPE_IN", "ENTRY_TYPE_OUT",
    "FlowRule", "DegradeRule", "SystemRule", "AuthorityRule",
    "ParamFlowRule", "ParamFlowItem", "PARAM_BEHAVIOR_RATE_LIMITER",
    "BlockException", "FlowException", "DegradeException",
    "SystemBlockException", "AuthorityException", "ParamFlowException",
    "CustomSlotException", "BlockReason", "ErrorEntryFreeError",
    "HostGate", "DeviceSlot", "DeviceSlotView",
    "GRADE_QPS", "GRADE_THREAD", "GRADE_RT", "GRADE_EXCEPTION_RATIO",
    "GRADE_EXCEPTION_COUNT",
    "BEHAVIOR_DEFAULT", "BEHAVIOR_WARM_UP", "BEHAVIOR_RATE_LIMITER",
    "BEHAVIOR_WARM_UP_RATE_LIMITER",
    "STRATEGY_DIRECT", "STRATEGY_RELATE", "STRATEGY_CHAIN",
    "STRATEGY_WHITE", "STRATEGY_BLACK",
    "Clock", "ManualClock", "SystemClock", "set_global_clock",
    "SentinelConfig", "load_config",
]
