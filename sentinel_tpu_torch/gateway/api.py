"""Custom API ("API group") definitions with path predicates.

Reference: ``sentinel-api-gateway-adapter-common/.../api/``
(``ApiDefinition.java``, ``ApiPathPredicateItem.java``,
``GatewayApiDefinitionManager.java``) and the concrete matcher behavior in
``sentinel-spring-cloud-gateway-adapter/.../WebExchangeApiMatcher.java:56-69``:
EXACT = equality, PREFIX = ant path (``/foo/**``), REGEX = full match.
An API matches when ANY of its predicate items matches
(``AbstractApiMatcher.test:57-64``).

The PyTorch port's copy of ``sentinel_tpu/gateway/api.py``."""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Dict, List, Optional, Sequence

URL_MATCH_STRATEGY_EXACT = 0
URL_MATCH_STRATEGY_PREFIX = 1
URL_MATCH_STRATEGY_REGEX = 2


@dataclasses.dataclass(frozen=True)
class ApiPathPredicateItem:
    pattern: str
    match_strategy: int = URL_MATCH_STRATEGY_EXACT


@dataclasses.dataclass(frozen=True)
class ApiDefinition:
    api_name: str
    predicate_items: tuple = ()

    def is_valid(self) -> bool:
        return bool(self.api_name) and self.predicate_items is not None


def _ant_to_regex(pattern: str) -> "re.Pattern":
    """Ant-style path pattern → regex (`**` any depth, `*` one segment,
    `?` one char) — the PREFIX strategy's matcher."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "*":
            if pattern[i:i + 2] == "**":
                out.append(".*")
                i += 2
                continue
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out) + r"\Z")


class _ApiMatcher:
    def __init__(self, definition: ApiDefinition):
        self.api_name = definition.api_name
        self.definition = definition
        self._preds = []
        for item in definition.predicate_items:
            if not item.pattern:
                continue
            if item.match_strategy == URL_MATCH_STRATEGY_REGEX:
                rx = re.compile(item.pattern)
                self._preds.append(lambda p, rx=rx: rx.fullmatch(p) is not None)
            elif item.match_strategy == URL_MATCH_STRATEGY_PREFIX:
                rx = _ant_to_regex(item.pattern)
                self._preds.append(lambda p, rx=rx: rx.match(p) is not None)
            else:
                self._preds.append(lambda p, pat=item.pattern: p == pat)

    def test(self, path: str) -> bool:
        return any(pred(path) for pred in self._preds)


class GatewayApiDefinitionManager:
    """Registry of custom API groups; resolves a request path to the API
    names whose predicates match (``GatewayApiDefinitionManager`` + the
    per-adapter matcher caches)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._defs: Dict[str, ApiDefinition] = {}
        self._matchers: List[_ApiMatcher] = []
        self._listeners = []

    def load_api_definitions(self, definitions: Sequence[ApiDefinition]) -> None:
        valid = [d for d in definitions if d.is_valid()]
        with self._lock:
            self._defs = {d.api_name: d for d in valid}
            self._matchers = [_ApiMatcher(d) for d in valid]
        for listener in list(self._listeners):
            listener(valid)

    def add_listener(self, fn) -> None:
        """``ApiDefinitionChangeObserver`` analog."""
        self._listeners.append(fn)

    def get_api_definition(self, api_name: str) -> Optional[ApiDefinition]:
        with self._lock:
            return self._defs.get(api_name)

    def get_api_definitions(self) -> List[ApiDefinition]:
        with self._lock:
            return list(self._defs.values())

    def matching_apis(self, path: str) -> List[str]:
        """All custom-API resource names whose predicates match the path."""
        with self._lock:
            matchers = list(self._matchers)
        return [m.api_name for m in matchers if m.test(path)]
