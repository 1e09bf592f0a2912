"""Origin authority rules (AuthoritySlot).

Port of ``sentinel_tpu/rules/authority.py``. Reference
(``AuthorityRuleChecker``): ``limitApp`` is a comma-separated origin
list; WHITE passes only origins in the list, BLACK blocks them; an empty
event origin always passes. Origins intern into registry ids, so
membership is an integer set probe over per-rule padded id lists
``origin_ids[NA, M]`` (-1 pad).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.ops import segments as seg

STRATEGY_WHITE = 0
STRATEGY_BLACK = 1

MAX_ORIGINS_PER_RULE = 16


@dataclasses.dataclass
class AuthorityRule:
    resource: str
    limit_app: str               # comma-separated origins
    strategy: int = STRATEGY_WHITE

    def is_valid(self) -> bool:
        return bool(self.resource) and bool(self.limit_app.strip()) and \
            self.strategy in (STRATEGY_WHITE, STRATEGY_BLACK)


class AuthorityRuleTable(NamedTuple):
    active: torch.Tensor        # bool[NA+1]
    strategy: torch.Tensor      # int32[NA+1]
    origin_ids: torch.Tensor    # int32[NA+1, M], -1 padded


class CompiledAuthorityRules(NamedTuple):
    table: AuthorityRuleTable
    rule_idx: torch.Tensor      # int32[R, Ka]
    rules: Tuple[AuthorityRule, ...]
    num_active: int


def compile_authority_rules(rules: Sequence[AuthorityRule], *, resource_registry,
                            origin_registry, capacity: int, k_per_resource: int,
                            num_rows: int,
                            device="cpu") -> CompiledAuthorityRules:
    valid = [r for r in rules if r.is_valid()]
    if len(valid) > capacity:
        raise ValueError(f"too many authority rules: {len(valid)} > {capacity}")
    na = capacity
    active = np.zeros(na + 1, np.bool_)
    strategy = np.zeros(na + 1, np.int32)
    origin_ids = np.full((na + 1, MAX_ORIGINS_PER_RULE), -1, np.int32)
    rule_idx = np.full((num_rows, k_per_resource), na, np.int32)
    slots_used = {}
    for j, r in enumerate(valid):
        row = resource_registry.pin(r.resource)
        k = slots_used.get(row, 0)
        if k >= k_per_resource:
            raise ValueError(
                f"more than {k_per_resource} authority rules for {r.resource!r}")
        slots_used[row] = k + 1
        rule_idx[row, k] = j
        active[j] = True
        strategy[j] = r.strategy
        origins = [o.strip() for o in r.limit_app.split(",") if o.strip()]
        if len(origins) > MAX_ORIGINS_PER_RULE:
            raise ValueError(
                f"authority rule for {r.resource!r} lists {len(origins)} origins "
                f"(max {MAX_ORIGINS_PER_RULE})")
        for m, o in enumerate(origins):
            origin_ids[j, m] = origin_registry.pin(o)
    table = AuthorityRuleTable(*(torch.from_numpy(a).to(device)
                                 for a in (active, strategy, origin_ids)))
    return CompiledAuthorityRules(table=table,
                                  rule_idx=torch.from_numpy(rule_idx).to(device),
                                  rules=tuple(valid), num_active=len(valid))


def authority_check(
    table: AuthorityRuleTable, rule_idx: torch.Tensor,
    rows: torch.Tensor, origin_ids: torch.Tensor, valid: torch.Tensor,
) -> torch.Tensor:
    """→ allow bool[B] (False = AuthorityException)."""
    NA = table.active.shape[0] - 1
    rules_bk = seg.padded_table_gather(rule_idx, rows, NA).long()  # [B, Ka]
    act = table.active[rules_bk]
    member = (table.origin_ids[rules_bk]
              == origin_ids[:, None, None]).any(dim=2)              # [B, Ka]
    rule_ok = torch.where(table.strategy[rules_bk] == STRATEGY_WHITE,
                          member, ~member)
    # empty origin (id 0) always passes (AuthorityRuleChecker early return)
    rule_ok = rule_ok | (origin_ids == 0)[:, None] | ~act
    return rule_ok.all(dim=1) | ~valid
