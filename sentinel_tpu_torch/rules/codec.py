"""Rule ⇄ JSON codecs in the reference wire format.

Field names match the fastjson serialization of the reference's rule beans
(``FlowRule.java``, ``DegradeRule.java``, ``SystemRule.java``,
``AuthorityRule.java``, ``ParamFlowRule.java`` + ``ParamFlowItem``), i.e. the
format the Sentinel dashboard pushes via ``setRules`` and datasources store —
so rule files and dashboard payloads are interchangeable between the
reference and this framework.

The PyTorch port's own copy of ``sentinel_tpu/rules/codec.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

from sentinel_tpu_torch.rules.authority import AuthorityRule
from sentinel_tpu_torch.rules.degrade import DegradeRule
from sentinel_tpu_torch.rules.flow import FlowRule
from sentinel_tpu_torch.rules.param_flow import ParamFlowItem, ParamFlowRule
from sentinel_tpu_torch.rules.system import SystemRule


def flow_rule_to_dict(r: FlowRule) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "resource": r.resource, "limitApp": r.limit_app, "grade": r.grade,
        "count": r.count, "strategy": r.strategy,
        "refResource": r.ref_resource, "controlBehavior": r.control_behavior,
        "warmUpPeriodSec": r.warm_up_period_sec,
        "maxQueueingTimeMs": r.max_queueing_time_ms,
        "clusterMode": r.cluster_mode,
    }
    if r.cluster_mode:
        d["clusterConfig"] = {
            "flowId": r.cluster_flow_id,
            "thresholdType": r.cluster_threshold_type,
            "fallbackToLocalWhenFail": r.cluster_fallback_to_local,
        }
    return d


def flow_rule_from_dict(d: Dict[str, Any]) -> FlowRule:
    cc = d.get("clusterConfig") or {}
    return FlowRule(
        resource=d["resource"],
        count=float(d.get("count", 0.0)),
        grade=int(d.get("grade", 1)),
        limit_app=d.get("limitApp") or "default",
        strategy=int(d.get("strategy", 0)),
        ref_resource=d.get("refResource") or "",
        control_behavior=int(d.get("controlBehavior", 0)),
        warm_up_period_sec=int(d.get("warmUpPeriodSec", 10)),
        max_queueing_time_ms=int(d.get("maxQueueingTimeMs", 500)),
        cluster_mode=bool(d.get("clusterMode", False)),
        cluster_flow_id=int(cc.get("flowId", 0)),
        cluster_threshold_type=int(cc.get("thresholdType", 0)),
        cluster_fallback_to_local=bool(cc.get("fallbackToLocalWhenFail", True)),
    )


def degrade_rule_to_dict(r: DegradeRule) -> Dict[str, Any]:
    return {
        "resource": r.resource, "grade": r.grade, "count": r.count,
        "timeWindow": r.time_window, "minRequestAmount": r.min_request_amount,
        "statIntervalMs": r.stat_interval_ms,
        "slowRatioThreshold": r.slow_ratio_threshold,
    }


def degrade_rule_from_dict(d: Dict[str, Any]) -> DegradeRule:
    return DegradeRule(
        resource=d["resource"], grade=int(d.get("grade", 0)),
        count=float(d.get("count", 0.0)),
        time_window=int(d.get("timeWindow", 0)),
        min_request_amount=int(d.get("minRequestAmount", 5)),
        stat_interval_ms=int(d.get("statIntervalMs", 1000)),
        slow_ratio_threshold=float(d.get("slowRatioThreshold", 1.0)),
    )


def system_rule_to_dict(r: SystemRule) -> Dict[str, Any]:
    return {
        "highestSystemLoad": r.highest_system_load,
        "highestCpuUsage": r.highest_cpu_usage,
        "qps": r.qps, "avgRt": r.avg_rt, "maxThread": r.max_thread,
    }


def system_rule_from_dict(d: Dict[str, Any]) -> SystemRule:
    return SystemRule(
        highest_system_load=float(d.get("highestSystemLoad", -1.0)),
        highest_cpu_usage=float(d.get("highestCpuUsage", -1.0)),
        qps=float(d.get("qps", -1.0)),
        avg_rt=float(d.get("avgRt", -1.0)),
        max_thread=float(d.get("maxThread", -1.0)),
    )


def authority_rule_to_dict(r: AuthorityRule) -> Dict[str, Any]:
    return {"resource": r.resource, "limitApp": r.limit_app,
            "strategy": r.strategy}


def authority_rule_from_dict(d: Dict[str, Any]) -> AuthorityRule:
    return AuthorityRule(
        resource=d["resource"], limit_app=d.get("limitApp") or "",
        strategy=int(d.get("strategy", 0)))


def param_flow_rule_to_dict(r: ParamFlowRule) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "resource": r.resource, "paramIdx": r.param_idx, "count": r.count,
        "grade": r.grade, "durationInSec": r.duration_in_sec,
        "burstCount": r.burst_count, "controlBehavior": r.control_behavior,
        "maxQueueingTimeMs": r.max_queueing_time_ms,
        "clusterMode": r.cluster_mode,
        "paramFlowItemList": [
            {"object": str(it.object), "count": it.count,
             "classType": it.class_type or type(it.object).__name__}
            for it in r.param_flow_item_list],
    }
    if r.cluster_mode:
        d["clusterConfig"] = {"flowId": r.cluster_flow_id}
    return d


_ITEM_TYPES = {"int": int, "Integer": int, "long": int, "Long": int,
               "float": float, "Float": float, "double": float,
               "Double": float, "bool": bool, "boolean": bool,
               "Boolean": bool}


def _parse_item_object(obj: Any, class_type: str) -> Any:
    if not isinstance(obj, str):
        return obj
    conv = _ITEM_TYPES.get(class_type)
    if conv is bool:
        return obj in ("true", "True")
    if conv is not None:
        try:
            return conv(obj)
        except ValueError:
            return obj
    return obj


def param_flow_rule_from_dict(d: Dict[str, Any]) -> ParamFlowRule:
    cc = d.get("clusterConfig") or {}
    items = [ParamFlowItem(
        object=_parse_item_object(it.get("object"), it.get("classType", "")),
        count=int(it.get("count", 0)),
        class_type=it.get("classType", ""))
        for it in d.get("paramFlowItemList") or []]
    return ParamFlowRule(
        resource=d["resource"], param_idx=int(d.get("paramIdx", 0)),
        count=float(d.get("count", 0.0)), grade=int(d.get("grade", 1)),
        duration_in_sec=int(d.get("durationInSec", 1)),
        burst_count=int(d.get("burstCount", 0)),
        control_behavior=int(d.get("controlBehavior", 0)),
        max_queueing_time_ms=int(d.get("maxQueueingTimeMs", 0)),
        param_flow_item_list=items,
        cluster_mode=bool(d.get("clusterMode", False)),
        cluster_flow_id=int(cc.get("flowId", 0)),
    )


_TO = {"flow": flow_rule_to_dict, "degrade": degrade_rule_to_dict,
       "system": system_rule_to_dict, "authority": authority_rule_to_dict,
       "paramFlow": param_flow_rule_to_dict}
_FROM = {"flow": flow_rule_from_dict, "degrade": degrade_rule_from_dict,
         "system": system_rule_from_dict, "authority": authority_rule_from_dict,
         "paramFlow": param_flow_rule_from_dict}

RULE_TYPES = tuple(_TO)


def rules_to_json(rule_type: str, rules: Sequence[Any]) -> str:
    return json.dumps([_TO[rule_type](r) for r in rules])


def rules_from_json(rule_type: str, text: str) -> List[Any]:
    data = json.loads(text) if text.strip() else []
    return [_FROM[rule_type](d) for d in data]
