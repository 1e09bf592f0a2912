"""Request-attribute extraction for gateway rules.

Reference: ``GatewayParamParser.java`` — for each of a resource's gateway
rules with a param item, pull the configured attribute (client IP / Host /
header / URL param / cookie) out of the request and place it at the rule's
assigned index in the args array; values failing the rule's pattern filter
become ``$NM`` (which the converted rule's per-item override passes freely);
rules without a param item share a trailing ``$D`` slot
(``parseParameterFor:52-85``). Match strategies: exact / contains / regex
(cached, ``GatewayRegexCache``) / prefix (``parseWithMatchStrategyInternal``).

The PyTorch port's copy of ``sentinel_tpu/gateway/param.py``.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Protocol

from sentinel_tpu_torch.gateway.rules import (
    GATEWAY_DEFAULT_PARAM,
    GATEWAY_NOT_MATCH_PARAM,
    PARAM_MATCH_STRATEGY_CONTAINS,
    PARAM_MATCH_STRATEGY_EXACT,
    PARAM_MATCH_STRATEGY_PREFIX,
    PARAM_MATCH_STRATEGY_REGEX,
    PARAM_PARSE_STRATEGY_CLIENT_IP,
    PARAM_PARSE_STRATEGY_COOKIE,
    PARAM_PARSE_STRATEGY_HEADER,
    PARAM_PARSE_STRATEGY_HOST,
    PARAM_PARSE_STRATEGY_URL_PARAM,
    GatewayFlowRule,
    GatewayParamFlowItem,
    GatewayRuleManager,
)

_REGEX_CACHE: dict = {}


def _cached_regex(pattern: str) -> Optional["re.Pattern"]:
    rx = _REGEX_CACHE.get(pattern)
    if rx is None:
        try:
            rx = re.compile(pattern)
        except re.error:
            return None
        _REGEX_CACHE[pattern] = rx
    return rx


class RequestItemParser(Protocol):
    """Adapter-facing request accessor (``RequestItemParser.java``)."""

    def get_path(self, request) -> str: ...
    def get_remote_address(self, request) -> Optional[str]: ...
    def get_header(self, request, key: str) -> Optional[str]: ...
    def get_url_param(self, request, name: str) -> Optional[str]: ...
    def get_cookie_value(self, request, name: str) -> Optional[str]: ...


class DictRequestItemParser:
    """Plain-dict requests: ``{"path", "remote", "headers", "params",
    "cookies"}`` — the test/reference-free parser, also used by the WSGI
    adapter after environ normalization."""

    def get_path(self, request) -> str:
        return request.get("path", "")

    def get_remote_address(self, request) -> Optional[str]:
        return request.get("remote")

    def get_header(self, request, key: str) -> Optional[str]:
        headers = request.get("headers") or {}
        return headers.get(key) or headers.get(key.lower())

    def get_url_param(self, request, name: str) -> Optional[str]:
        return (request.get("params") or {}).get(name)

    def get_cookie_value(self, request, name: str) -> Optional[str]:
        return (request.get("cookies") or {}).get(name)


def _match_value(strategy: int, value: Optional[str],
                 pattern: str) -> Optional[str]:
    """``parseWithMatchStrategyInternal:156-174`` — non-matching → $NM."""
    if value is None:
        return None
    if strategy == PARAM_MATCH_STRATEGY_EXACT:
        return value if value == pattern else GATEWAY_NOT_MATCH_PARAM
    if strategy == PARAM_MATCH_STRATEGY_CONTAINS:
        return value if pattern in value else GATEWAY_NOT_MATCH_PARAM
    if strategy == PARAM_MATCH_STRATEGY_PREFIX:
        return value if value.startswith(pattern) else GATEWAY_NOT_MATCH_PARAM
    if strategy == PARAM_MATCH_STRATEGY_REGEX:
        rx = _cached_regex(pattern)
        if rx is None:
            return value
        return value if rx.fullmatch(value) else GATEWAY_NOT_MATCH_PARAM
    return value


class GatewayParamParser:
    """Builds the entry args for a gateway resource from a live request."""

    def __init__(self, manager: GatewayRuleManager,
                 item_parser: Optional[RequestItemParser] = None):
        self._manager = manager
        self._parser = item_parser or DictRequestItemParser()

    def _parse_item(self, item: GatewayParamFlowItem, request) -> Optional[str]:
        p = self._parser
        strategy = item.parse_strategy
        if strategy == PARAM_PARSE_STRATEGY_CLIENT_IP:
            value = p.get_remote_address(request)
        elif strategy == PARAM_PARSE_STRATEGY_HOST:
            value = p.get_header(request, "Host")
        elif strategy == PARAM_PARSE_STRATEGY_HEADER:
            value = p.get_header(request, item.field_name)
        elif strategy == PARAM_PARSE_STRATEGY_URL_PARAM:
            value = p.get_url_param(request, item.field_name)
        elif strategy == PARAM_PARSE_STRATEGY_COOKIE:
            value = p.get_cookie_value(request, item.field_name)
        else:
            return None
        if not item.pattern:
            return value
        return _match_value(item.match_strategy, value, item.pattern)

    def parse_parameters(self, resource: str, request,
                         rule_predicate: Optional[Callable[[GatewayFlowRule], bool]] = None
                         ) -> List[Optional[str]]:
        """→ args for ``Sentinel.entry(resource, args=...)``.

        ``rule_predicate`` filters which rules apply (the Spring Cloud
        adapter uses it for API-vs-route scoping); mixed verdicts → no args
        (``parseParameterFor:69-71``)."""
        if not resource or request is None:
            return []
        param_rules = []
        preds = set()
        has_non_param = False
        for rule in self._manager.rules_for_resource(resource):
            if rule.param_item is not None:
                param_rules.append(rule)
                if rule_predicate is not None:
                    preds.add(bool(rule_predicate(rule)))
            else:
                has_non_param = True
        if not param_rules and not has_non_param:
            return []
        if len(preds) > 1 or False in preds:
            return []
        size = len(param_rules) + (1 if has_non_param else 0)
        args: List[Optional[str]] = [None] * size
        for rule in param_rules:
            idx = rule.param_item.index
            if idx is not None and 0 <= idx < size:
                args[idx] = self._parse_item(rule.param_item, request)
        if has_non_param:
            args[size - 1] = GATEWAY_DEFAULT_PARAM
        return args
