"""Hot-parameter rules (``ParamFlowRule``): grade and behaviour by name,
hot items (``param_flow_item_list``) as ``{"object": value, "count":
n}`` entries (``ParamFlowItem``)."""

from portbench.deploy import name_of

CODES = {"grade": ({"THREAD": 0, "QPS": 1}, "QPS"),
         "control_behavior": ({"DEFAULT": 0, "RATE_LIMITER": 2},
                              "DEFAULT")}


def load(stt, sph, rules) -> None:
    sph.load_param_flow_rules([
        stt.ParamFlowRule(
            resource=name_of(i), **{**fields, "param_flow_item_list": [
                stt.ParamFlowItem(it["object"], it["count"])
                for it in fields.get("param_flow_item_list", ())]})
        for i, fields in rules])
