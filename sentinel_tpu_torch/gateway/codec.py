"""Gateway rule / API-definition JSON codecs (reference
``sentinel-api-gateway-adapter-common``'s command payloads — field names
match ``GatewayFlowRule.java`` / ``ApiDefinition.java`` fastjson output so
the reference dashboard's gateway screens can drive these agents).

The PyTorch port's copy of ``sentinel_tpu/gateway/codec.py``."""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

from sentinel_tpu_torch.gateway.api import ApiDefinition, ApiPathPredicateItem
from sentinel_tpu_torch.gateway.rules import GatewayFlowRule, GatewayParamFlowItem


def gateway_rule_to_dict(r: GatewayFlowRule) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "resource": r.resource, "resourceMode": r.resource_mode,
        "grade": r.grade, "count": r.count, "intervalSec": r.interval_sec,
        "controlBehavior": r.control_behavior, "burst": r.burst,
        "maxQueueingTimeoutMs": r.max_queueing_timeout_ms,
    }
    if r.param_item is not None:
        p = r.param_item
        d["paramItem"] = {
            "parseStrategy": p.parse_strategy, "fieldName": p.field_name,
            "pattern": p.pattern, "matchStrategy": p.match_strategy,
        }
    return d


def gateway_rule_from_dict(d: Dict[str, Any]) -> GatewayFlowRule:
    item = None
    if d.get("paramItem"):
        p = d["paramItem"]
        item = GatewayParamFlowItem(
            parse_strategy=int(p.get("parseStrategy", 0)),
            field_name=str(p.get("fieldName", "") or ""),
            pattern=str(p.get("pattern", "") or ""),
            match_strategy=int(p.get("matchStrategy", 0)))
    return GatewayFlowRule(
        resource=str(d["resource"]),
        resource_mode=int(d.get("resourceMode", 0)),
        grade=int(d.get("grade", 1)),
        count=float(d.get("count", 0.0)),
        interval_sec=int(d.get("intervalSec", 1)),
        control_behavior=int(d.get("controlBehavior", 0)),
        burst=int(d.get("burst", 0)),
        max_queueing_timeout_ms=int(d.get("maxQueueingTimeoutMs", 500)),
        param_item=item)


def api_definition_to_dict(a: ApiDefinition) -> Dict[str, Any]:
    return {"apiName": a.api_name, "predicateItems": [
        {"pattern": p.pattern, "matchStrategy": p.match_strategy}
        for p in a.predicate_items]}


def api_definition_from_dict(d: Dict[str, Any]) -> ApiDefinition:
    items = tuple(ApiPathPredicateItem(
        pattern=str(p.get("pattern", "")),
        match_strategy=int(p.get("matchStrategy", 0)))
        for p in d.get("predicateItems", []) or [])
    return ApiDefinition(api_name=str(d["apiName"]), predicate_items=items)


def gateway_rules_to_json(rules: Sequence[GatewayFlowRule]) -> str:
    return json.dumps([gateway_rule_to_dict(r) for r in rules])


def gateway_rules_from_json(text: str) -> List[GatewayFlowRule]:
    return [gateway_rule_from_dict(d) for d in json.loads(text or "[]")]


def api_definitions_to_json(defs: Sequence[ApiDefinition]) -> str:
    return json.dumps([api_definition_to_dict(a) for a in defs])


def api_definitions_from_json(text: str) -> List[ApiDefinition]:
    return [api_definition_from_dict(d) for d in json.loads(text or "[]")]
