"""graftlint rule registry.

Order here is presentation order in ``--list-rules``; rule ids are
stable API (suppression comments reference them).
"""

from __future__ import annotations

from typing import Dict, List

from sentinel_tpu_torch.analysis.core import Rule
from sentinel_tpu_torch.analysis.rules.spmd import SpmdRule
from sentinel_tpu_torch.analysis.rules.device import DeviceImportRule
from sentinel_tpu_torch.analysis.rules.trace import TraceHygieneRule
from sentinel_tpu_torch.analysis.rules.async_block import AsyncBlockingRule
from sentinel_tpu_torch.analysis.rules.locks import SharedStateRule
from sentinel_tpu_torch.analysis.rules.lockdiscipline import LockDisciplineRule
from sentinel_tpu_torch.analysis.rules.donate import UseAfterDispatchRule
from sentinel_tpu_torch.analysis.rules.order import IntentBeforeFreeRule
from sentinel_tpu_torch.analysis.rules.registry import RegistryDriftRule

ALL_RULES: List[Rule] = [
    SpmdRule(),
    DeviceImportRule(),
    TraceHygieneRule(),
    AsyncBlockingRule(),
    SharedStateRule(),
    LockDisciplineRule(),
    UseAfterDispatchRule(),
    IntentBeforeFreeRule(),
    RegistryDriftRule(),
]

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in ALL_RULES}
