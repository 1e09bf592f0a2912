"""Gateway flow rules and their conversion onto the hot-param engine.

Reference semantics (``sentinel-api-gateway-adapter-common``):

* ``GatewayFlowRule.java:30-47`` — field parity: resource (route id or custom
  API name), resourceMode, grade (QPS default), count, intervalSec=1,
  controlBehavior, burst, maxQueueingTimeoutMs=500, optional
  ``GatewayParamFlowItem`` (parseStrategy, fieldName, pattern, matchStrategy).
* ``GatewayRuleConverter.java:29-88`` — every gateway rule becomes a
  ``ParamFlowRule``; pattern-based items get a ``$NM`` (not-match) per-item
  override with a huge threshold so non-matching traffic passes freely
  (``generateNonMatchPassParamItem``).
* ``GatewayRuleManager.applyGatewayRuleInternal:179-237`` — per-resource
  parameter indices are assigned densely to param-item rules (0..n-1); rules
  WITHOUT a param item all share the next index and throttle the single
  synthetic value ``$D`` (so a plain per-route QPS cap rides the same
  machinery, ``applyNonParamToParamRule``).
* ``GatewayRuleManager.isValidRule:117-134`` — validation parity.

The PyTorch port's copy of ``sentinel_tpu/gateway/rules.py``. The
converted ``ParamFlowRule`` set is handed to the runtime's param-flow
engine (one merged param slot — the reference's separate
``GatewayFlowSlot`` checks the same converted rules against the same
entry args, so merging is semantics-preserving); gateway entries pass
the parsed request attributes as their ``args``, so gateway traffic runs
the param slot's device path (the scatter-add kernel for tokens and
THREAD gauges).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from sentinel_tpu_torch.rules import param_flow as pf

RESOURCE_MODE_ROUTE_ID = 0
RESOURCE_MODE_CUSTOM_API_NAME = 1

PARAM_PARSE_STRATEGY_CLIENT_IP = 0
PARAM_PARSE_STRATEGY_HOST = 1
PARAM_PARSE_STRATEGY_HEADER = 2
PARAM_PARSE_STRATEGY_URL_PARAM = 3
PARAM_PARSE_STRATEGY_COOKIE = 4

PARAM_MATCH_STRATEGY_EXACT = 0
PARAM_MATCH_STRATEGY_PREFIX = 1
PARAM_MATCH_STRATEGY_REGEX = 2
PARAM_MATCH_STRATEGY_CONTAINS = 3

GATEWAY_NOT_MATCH_PARAM = "$NM"
GATEWAY_DEFAULT_PARAM = "$D"

_NOT_MATCH_PASS_COUNT = 10_000_000   # generateNonMatchPassParamItem threshold

GRADE_QPS = pf.GRADE_QPS
GRADE_THREAD = pf.GRADE_THREAD


@dataclasses.dataclass
class GatewayParamFlowItem:
    """What request attribute to throttle by (``GatewayParamFlowItem.java``)."""

    parse_strategy: int = PARAM_PARSE_STRATEGY_CLIENT_IP
    field_name: str = ""                 # header/url-param/cookie name
    pattern: str = ""                    # optional value filter
    match_strategy: int = PARAM_MATCH_STRATEGY_EXACT
    index: Optional[int] = None          # assigned at load time

    def is_valid(self) -> bool:
        if self.parse_strategy not in (
                PARAM_PARSE_STRATEGY_CLIENT_IP, PARAM_PARSE_STRATEGY_HOST,
                PARAM_PARSE_STRATEGY_HEADER, PARAM_PARSE_STRATEGY_URL_PARAM,
                PARAM_PARSE_STRATEGY_COOKIE):
            return False
        if self.parse_strategy in (PARAM_PARSE_STRATEGY_HEADER,
                                   PARAM_PARSE_STRATEGY_URL_PARAM,
                                   PARAM_PARSE_STRATEGY_COOKIE) \
                and not self.field_name:
            return False
        return True


@dataclasses.dataclass
class GatewayFlowRule:
    """Gateway-granularity flow rule (``GatewayFlowRule.java`` field parity)."""

    resource: str
    resource_mode: int = RESOURCE_MODE_ROUTE_ID
    grade: int = GRADE_QPS
    count: float = 0.0
    interval_sec: int = 1
    control_behavior: int = pf.BEHAVIOR_DEFAULT
    burst: int = 0
    max_queueing_timeout_ms: int = 500
    param_item: Optional[GatewayParamFlowItem] = None

    def is_valid(self) -> bool:
        if (not self.resource or self.resource_mode < 0 or self.grade < 0
                or self.count < 0 or self.burst < 0
                or self.control_behavior < 0 or self.interval_sec <= 0):
            return False
        if (self.control_behavior == pf.BEHAVIOR_RATE_LIMITER
                and self.max_queueing_timeout_ms < 0):
            return False
        if self.param_item is not None:
            return self.param_item.is_valid()
        return True


def _to_param_rule(rule: GatewayFlowRule, idx: int) -> pf.ParamFlowRule:
    """``GatewayRuleConverter.applyToParamRule`` / ``applyNonParamToParamRule``."""
    items: List[pf.ParamFlowItem] = []
    if rule.param_item is not None and rule.param_item.pattern:
        # pattern-based matching: the parser maps non-matching values to $NM,
        # which this per-item override lets through at an effectively
        # unlimited rate (generateNonMatchPassParamItem)
        items.append(pf.ParamFlowItem(object=GATEWAY_NOT_MATCH_PARAM,
                                      count=_NOT_MATCH_PASS_COUNT))
    return pf.ParamFlowRule(
        resource=rule.resource,
        param_idx=idx,
        count=rule.count,
        grade=rule.grade,
        duration_in_sec=rule.interval_sec,
        burst_count=rule.burst,
        control_behavior=rule.control_behavior,
        max_queueing_time_ms=rule.max_queueing_timeout_ms,
        param_flow_item_list=items,
    )


class GatewayRuleManager:
    """Holds gateway rules for one Sentinel instance and keeps the converted
    param-rule set installed (``GatewayRuleManager`` + ``GatewayFlowSlot``)."""

    def __init__(self, sentinel):
        import threading
        self._sentinel = sentinel
        self._load_lock = threading.Lock()   # command threads race reloads
        self._rules: Dict[str, List[GatewayFlowRule]] = {}
        # resource → number of param-item indices (the args-array length is
        # this plus one shared slot for non-param rules, filled with $D)
        self._param_idx_count: Dict[str, int] = {}
        self._has_non_param: Dict[str, bool] = {}

    def load_rules(self, rules: Sequence[GatewayFlowRule]) -> None:
        rule_map: Dict[str, List[GatewayFlowRule]] = {}
        idx_map: Dict[str, int] = {}
        has_non_param: Dict[str, bool] = {}
        converted: List[pf.ParamFlowRule] = []
        non_param: List[GatewayFlowRule] = []

        for rule in rules:
            if not rule.is_valid():
                continue
            rule_map.setdefault(rule.resource, []).append(rule)
            if rule.param_item is None:
                non_param.append(rule)
                has_non_param[rule.resource] = True
            else:
                idx = idx_map.get(rule.resource, 0)
                rule.param_item.index = idx
                idx_map[rule.resource] = idx + 1
                converted.append(_to_param_rule(rule, idx))
        # non-param rules all share the resource's LAST index; their traffic
        # is the synthetic $D value the parser appends
        for rule in non_param:
            converted.append(_to_param_rule(rule, idx_map.get(rule.resource, 0)))

        # one lock around the multi-map swap + param-rule install: two
        # concurrent command-plane reloads must not interleave (the parser's
        # args_length would disagree with the installed rules)
        with self._load_lock:
            self._rules = rule_map
            self._param_idx_count = idx_map
            self._has_non_param = has_non_param
            self._sentinel.set_gateway_param_rules(converted)

    def rules_for_resource(self, resource: str) -> List[GatewayFlowRule]:
        return list(self._rules.get(resource, ()))

    def all_rules(self) -> List[GatewayFlowRule]:
        return [r for rs in self._rules.values() for r in rs]

    def args_length(self, resource: str) -> int:
        """Length of the parsed-parameter array for a resource's entries."""
        n = self._param_idx_count.get(resource, 0)
        return n + (1 if self._has_non_param.get(resource) else 0)

    def has_non_param_rule(self, resource: str) -> bool:
        return bool(self._has_non_param.get(resource))
