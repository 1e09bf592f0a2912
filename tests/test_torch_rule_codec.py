"""Port parity: the rule JSON codec (``sentinel_tpu_torch.rules.codec``)
against ``sentinel_tpu.rules.codec``.

Randomized rules of every type, made from a numpy seed, are built in both
packages' rule dataclasses: every flow grade, behavior and strategy,
cluster fields, every degrade grade, authority strategies, system
thresholds, and param rules with items of every class type. The
comparison is exact: ``rules_to_json`` strings are byte-equal, either
package decodes either's output to equal rules, payloads with unknown keys
and missing fields decode alike, and the decoded rules loaded into twin
runtimes give equal engine tables.
"""

import dataclasses
import json

import numpy as np
import pytest

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.rules import codec as jcodec
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.rules import codec as tcodec

PKGS = {"jax": stpu, "torch": stt}
CODECS = {"jax": jcodec, "torch": tcodec}
T0 = 1_785_000_000_000

#: (classType string, object maker) of every param item class type the
#: codec knows, plus a string and an unnamed one
ITEM_TYPES = [
    ("int", lambda r: int(r.integers(-50, 50))),
    ("Integer", lambda r: int(r.integers(0, 1000))),
    ("long", lambda r: int(r.integers(2 ** 33, 2 ** 40))),
    ("Long", lambda r: int(r.integers(-2 ** 40, -2 ** 33))),
    ("float", lambda r: float(r.integers(0, 64)) / 4),
    ("Float", lambda r: float(r.integers(0, 64)) / 8),
    ("double", lambda r: float(r.integers(-99, 99)) / 16),
    ("Double", lambda r: float(r.integers(1, 99)) / 32),
    ("bool", lambda r: bool(r.integers(0, 2))),
    ("boolean", lambda r: bool(r.integers(0, 2))),
    ("Boolean", lambda r: bool(r.integers(0, 2))),
    ("String", lambda r: f"user-{int(r.integers(0, 99))}"),
    ("", lambda r: f"k{int(r.integers(0, 9))}"),
]


def _rule_kwargs(rtype: str, seed: int, n: int) -> list:
    """``n`` rules of ``rtype`` as constructor kwargs, drawn from
    ``seed`` (the same for both packages)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        res = f"res-{int(rng.integers(0, 8))}"
        if rtype == "flow":
            kw = dict(resource=res,
                      count=float(rng.integers(0, 400)) / 4,
                      grade=int(rng.integers(0, 2)),
                      limit_app=["default", "other", "app-a", "app-b"][
                          int(rng.integers(0, 4))],
                      strategy=int(rng.integers(0, 3)),
                      ref_resource=("ref" if rng.random() < 0.5 else ""),
                      control_behavior=int(rng.integers(0, 4)),
                      warm_up_period_sec=int(rng.integers(1, 30)),
                      max_queueing_time_ms=int(rng.integers(0, 2000)))
            if rng.random() < 0.4:
                kw.update(cluster_mode=True,
                          cluster_flow_id=int(rng.integers(1, 10_000)),
                          cluster_threshold_type=int(rng.integers(0, 2)),
                          cluster_fallback_to_local=bool(
                              rng.integers(0, 2)))
        elif rtype == "degrade":
            kw = dict(resource=res, grade=int(rng.integers(0, 3)),
                      count=float(rng.integers(1, 100)) / 10,
                      time_window=int(rng.integers(0, 60)),
                      min_request_amount=int(rng.integers(1, 20)),
                      stat_interval_ms=int(rng.choice([1000, 2000, 5000])),
                      slow_ratio_threshold=float(rng.integers(1, 10)) / 10)
        elif rtype == "system":
            kw = dict(highest_system_load=float(rng.integers(-1, 8)),
                      highest_cpu_usage=float(rng.integers(-1, 10)) / 10,
                      qps=float(rng.integers(-1, 5000)),
                      avg_rt=float(rng.integers(-1, 300)),
                      max_thread=float(rng.integers(-1, 64)))
        elif rtype == "authority":
            kw = dict(resource=res,
                      limit_app=",".join(f"app-{int(a)}" for a in
                                         rng.integers(0, 6, int(
                                             rng.integers(1, 4)))),
                      strategy=int(rng.integers(0, 2)))
        else:
            items = []
            for k in range(int(rng.integers(0, 4))):
                ct, make = ITEM_TYPES[int(rng.integers(0, len(ITEM_TYPES)))]
                items.append(dict(object=make(rng),
                                  count=int(rng.integers(0, 500)),
                                  class_type=ct))
            kw = dict(resource=res, param_idx=int(rng.integers(0, 3)),
                      count=float(rng.integers(0, 80)) / 2,
                      grade=int(rng.integers(0, 2)),
                      duration_in_sec=int(rng.integers(1, 5)),
                      burst_count=int(rng.integers(0, 10)),
                      control_behavior=int(rng.choice([0, 2])),
                      max_queueing_time_ms=int(rng.integers(0, 1000)),
                      items=items)
            if rng.random() < 0.3:
                kw.update(cluster_mode=True,
                          cluster_flow_id=int(rng.integers(1, 10_000)))
        out.append(kw)
    return out


def _build(pkg, rtype: str, kwargs: list) -> list:
    cls = {"flow": pkg.FlowRule, "degrade": pkg.DegradeRule,
           "system": pkg.SystemRule, "authority": pkg.AuthorityRule,
           "paramFlow": pkg.ParamFlowRule}[rtype]
    out = []
    for kw in kwargs:
        kw = dict(kw)
        if rtype == "paramFlow":
            kw["param_flow_item_list"] = [pkg.ParamFlowItem(**it)
                                          for it in kw.pop("items")]
        out.append(cls(**kw))
    return out


def _plain(rules) -> list:
    """Rules as plain values (the packages' dataclasses are different
    classes), with every leaf's type kept: 5 and 5.0 and True differ."""
    def typed(v):
        if isinstance(v, dict):
            return {k: typed(x) for k, x in v.items()}
        if isinstance(v, list):
            return [typed(x) for x in v]
        return (type(v).__name__, v)
    return [typed(dataclasses.asdict(r)) for r in rules]


RULE_TYPES = ("flow", "degrade", "system", "authority", "paramFlow")


def test_rule_types_are_the_references():
    assert tcodec.RULE_TYPES == jcodec.RULE_TYPES == RULE_TYPES


@pytest.mark.parametrize("seed", [3, 17, 2026])
@pytest.mark.parametrize("rtype", RULE_TYPES)
def test_rules_to_json_is_byte_equal(rtype, seed):
    kwargs = _rule_kwargs(rtype, seed, 24)
    text = {name: CODECS[name].rules_to_json(rtype, _build(pkg, rtype,
                                                           kwargs))
            for name, pkg in PKGS.items()}
    assert text["torch"] == text["jax"]
    assert text["torch"].encode("utf-8") == text["jax"].encode("utf-8")


@pytest.mark.parametrize("seed", [5, 29])
@pytest.mark.parametrize("rtype", RULE_TYPES)
def test_rules_from_json_of_either_output_agree(rtype, seed):
    kwargs = _rule_kwargs(rtype, seed, 24)
    for src, pkg in PKGS.items():
        text = CODECS[src].rules_to_json(rtype, _build(pkg, rtype, kwargs))
        got = {name: _plain(CODECS[name].rules_from_json(rtype, text))
               for name in CODECS}
        assert got["torch"] == got["jax"]
        # and the decoded rules encode back to the same bytes
        again = {name: CODECS[name].rules_to_json(
            rtype, CODECS[name].rules_from_json(rtype, text))
            for name in CODECS}
        assert again["torch"] == again["jax"]


#: payloads a dashboard or a config centre may send: fields missing
#: (defaults), unknown keys, nulls, item objects as strings of every class
#: type, empty and whitespace documents
RAW = {
    "flow": [
        {"resource": "a"},
        {"resource": "b", "count": 7, "grade": 0, "limitApp": None,
         "strategy": 1, "refResource": None, "controlBehavior": 3,
         "extra": {"x": 1}, "gmtCreate": 1700000000000},
        {"resource": "c", "clusterMode": True,
         "clusterConfig": {"flowId": 9, "thresholdType": 1,
                           "fallbackToLocalWhenFail": False,
                           "sampleCount": 10}},
        {"resource": "d", "clusterMode": False, "clusterConfig": None},
    ],
    "degrade": [{"resource": "a"},
                {"resource": "b", "grade": 2, "count": 3, "timeWindow": 5,
                 "minRequestAmount": 1, "statIntervalMs": 2000,
                 "slowRatioThreshold": 0.5, "id": 12}],
    "system": [{}, {"qps": 100, "avgRt": 20, "unknown": "x"}],
    "authority": [{"resource": "a"},
                  {"resource": "b", "limitApp": "x,y", "strategy": 1,
                   "app": "ignored"}],
    "paramFlow": [
        {"resource": "a"},
        {"resource": "b", "paramIdx": 1, "count": 4, "grade": 0,
         "paramFlowItemList": [
             {"object": "12", "count": 3, "classType": "int"},
             {"object": "1099511627776", "count": 4, "classType": "long"},
             {"object": "2.5", "count": 5, "classType": "double"},
             {"object": "true", "count": 6, "classType": "boolean"},
             {"object": "False", "count": 7, "classType": "Boolean"},
             {"object": "abc", "count": 8, "classType": "String"},
             {"object": "x1", "count": 9, "classType": "int"},
             {"object": 42, "count": 1},
             {"object": "k"}]},
        {"resource": "c", "clusterMode": True,
         "clusterConfig": {"flowId": 77, "thresholdType": 1},
         "paramFlowItemList": None},
    ],
}


@pytest.mark.parametrize("rtype", RULE_TYPES)
def test_defaults_and_unknown_keys_decode_alike(rtype):
    for doc in (json.dumps(RAW[rtype]), "", "   ", "[]"):
        got = {name: CODECS[name].rules_from_json(rtype, doc)
               for name in CODECS}
        assert _plain(got["torch"]) == _plain(got["jax"])
        assert tcodec.rules_to_json(rtype, got["torch"]) == \
            jcodec.rules_to_json(rtype, got["jax"])


@pytest.mark.parametrize("bad", ["{not json", "[{}]", "[1]", "{\"a\": 1}"])
def test_bad_documents_fail_alike(bad):
    for rtype in RULE_TYPES:
        errs = {}
        for name in CODECS:
            try:
                CODECS[name].rules_from_json(rtype, bad)
                errs[name] = None
            except Exception as exc:        # the handlers catch these
                errs[name] = type(exc).__name__
        assert errs["torch"] == errs["jax"], rtype


def _cfg(pkg):
    return pkg.load_config(max_resources=64, max_origins=16,
                           max_flow_rules=128, max_degrade_rules=64,
                           max_authority_rules=32, max_param_rules=64,
                           host_fast_path=False)


@pytest.mark.parametrize("seed", [7, 41])
def test_decoded_rules_give_equal_engine_tables(seed):
    """Each package decodes the same JSON and loads it: the runtimes'
    compiled rule tables (the port's, and the reference's carried through
    ``convert.ruleset_from_numpy``) are equal leaf by leaf."""
    docs = {}
    for rtype in RULE_TYPES:
        kwargs = _rule_kwargs(rtype, seed, 16 if rtype != "system" else 2)
        for i, kw in enumerate(kwargs):     # at most one rule a resource
            if "resource" in kw:
                kw["resource"] = f"{rtype}-{i}"
        for kw in kwargs:
            # cluster rules need a token service; keep them local here
            for key in ("cluster_mode", "cluster_flow_id",
                        "cluster_threshold_type", "cluster_fallback_to_local"):
                kw.pop(key, None)
        docs[rtype] = jcodec.rules_to_json(rtype, _build(stpu, rtype,
                                                         kwargs))
    runtimes = {}
    for name, pkg in PKGS.items():
        extra = {"device": "cpu"} if pkg is stt else {}
        sph = pkg.Sentinel(_cfg(pkg), clock=pkg.ManualClock(start_ms=T0),
                           **extra)
        c = CODECS[name]
        sph.load_flow_rules(c.rules_from_json("flow", docs["flow"]))
        sph.load_degrade_rules(c.rules_from_json("degrade",
                                                 docs["degrade"]))
        sph.load_system_rules(c.rules_from_json("system", docs["system"]))
        sph.load_authority_rules(c.rules_from_json("authority",
                                                   docs["authority"]))
        sph.load_param_flow_rules(c.rules_from_json("paramFlow",
                                                    docs["paramFlow"]))
        runtimes[name] = sph
    want = convert.to_numpy(convert.ruleset_from_numpy(
        convert.to_numpy(runtimes["jax"]._ruleset)))
    got = convert.to_numpy(runtimes["torch"]._ruleset)
    assert convert.leaf_diff(want, got) == []
    for rtype, getter in (("flow", "get_flow_rules"),
                          ("degrade", "get_degrade_rules"),
                          ("system", "get_system_rules"),
                          ("authority", "get_authority_rules"),
                          ("paramFlow", "get_param_flow_rules")):
        assert tcodec.rules_to_json(
            rtype, getattr(runtimes["torch"], getter)()) == \
            jcodec.rules_to_json(rtype, getattr(runtimes["jax"], getter)())
    for sph in runtimes.values():
        sph.close()
