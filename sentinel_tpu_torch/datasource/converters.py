"""JSON converters/encoders per rule type — the ``Converter<S,T>`` instances
every datasource is constructed with (reference demos wire
``new Converter<String, List<FlowRule>>`` around fastjson; here the codecs
are shared with the transport command handlers so file contents, dashboard
payloads, and datasource payloads are one format).

The PyTorch port's own copy of ``sentinel_tpu/datasource/converters.py``.
"""

from __future__ import annotations

from typing import Any, Callable, List

from sentinel_tpu_torch.rules import codec


def rule_converter(rule_type: str) -> Callable[[str], List[Any]]:
    if rule_type not in codec.RULE_TYPES:
        raise ValueError(f"unknown rule type: {rule_type}")
    return lambda text: codec.rules_from_json(rule_type, text or "[]")


def rule_encoder(rule_type: str) -> Callable[[List[Any]], str]:
    if rule_type not in codec.RULE_TYPES:
        raise ValueError(f"unknown rule type: {rule_type}")
    return lambda rules: codec.rules_to_json(rule_type, rules)
