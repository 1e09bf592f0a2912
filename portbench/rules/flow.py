"""Flow rules (``FlowRule``): grade, behaviour and strategy by name."""

from portbench.deploy import name_of

CODES = {"grade": ({"THREAD": 0, "QPS": 1}, "QPS"),
         "control_behavior": ({"DEFAULT": 0, "WARM_UP": 1,
                               "RATE_LIMITER": 2,
                               "WARM_UP_RATE_LIMITER": 3}, "DEFAULT"),
         "strategy": ({"DIRECT": 0, "RELATE": 1, "CHAIN": 2}, "DIRECT")}


def load(stt, sph, rules) -> None:
    sph.load_flow_rules([stt.FlowRule(resource=name_of(i), **fields)
                         for i, fields in rules])
