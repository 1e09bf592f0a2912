"""Circuit breakers (``DegradeRule``): the grade by name."""

from portbench.deploy import name_of

CODES = {"grade": ({"RT": 0, "EXCEPTION_RATIO": 1, "EXCEPTION_COUNT": 2},
                   None)}


def load(stt, sph, rules) -> None:
    sph.load_degrade_rules([stt.DegradeRule(resource=name_of(i), **fields)
                            for i, fields in rules])
