"""Pluggable dashboard rule pipeline — the v2
``DynamicRuleProvider`` / ``DynamicRulePublisher`` SPI.

Reference: ``sentinel-dashboard/.../rule/DynamicRuleProvider.java`` +
``DynamicRulePublisher.java`` with ``FlowRuleApiProvider``/``...ApiPublisher``
as the machine-direct defaults and config-center variants (the Nacos sample)
swapped in per rule type. Here: register a (provider, publisher) pair per
rule type on the :class:`Dashboard`; the existing CRUD endpoints then read
rules from / publish rules to the config center instead of the machines —
the agents pull the same store through a datasource
(``NacosDataSource``/``FileRefreshableDataSource``/...), closing the
dashboard → config-center → agent loop without direct pushes.

The PyTorch port's own copy of ``sentinel_tpu/dashboard/rulepipeline.py``.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional


class DynamicRuleProvider:
    """Fetch the current rule list (plain dicts) for an app from wherever
    rules live (config center, file, ...)."""

    def get_rules(self, app: str) -> List[dict]:
        raise NotImplementedError


class DynamicRulePublisher:
    """Publish the full rule list for an app to the rule store."""

    def publish(self, app: str, rules: List[dict]) -> None:
        raise NotImplementedError


class CallbackRuleProvider(DynamicRuleProvider):
    """Adapter over any ``fetch(app) -> List[dict]`` callable."""

    def __init__(self, fetch: Callable[[str], List[dict]]):
        self._fetch = fetch

    def get_rules(self, app: str) -> List[dict]:
        return list(self._fetch(app) or [])


class CallbackRulePublisher(DynamicRulePublisher):
    """Adapter over any ``publish(app, rules)`` callable."""

    def __init__(self, push: Callable[[str, List[dict]], None]):
        self._push = push

    def publish(self, app: str, rules: List[dict]) -> None:
        self._push(app, rules)


class FileRuleStore(DynamicRuleProvider, DynamicRulePublisher):
    """Provider + publisher over one JSON file per app — the smallest real
    config center (the reference's FileWritableDataSource closed the same
    loop agent-side). Layout: ``{dir}/{app}-{rtype}-rules.json``. Agents
    watch the same file with :class:`FileRefreshableDataSource`."""

    def __init__(self, directory: str, rtype: str):
        import os

        self.directory = directory
        self.rtype = rtype
        os.makedirs(directory, exist_ok=True)

    def path_for(self, app: str) -> str:
        import os

        return os.path.join(self.directory, f"{app}-{self.rtype}-rules.json")

    def get_rules(self, app: str) -> List[dict]:
        try:
            with open(self.path_for(app), encoding="utf-8") as fh:
                return json.load(fh)
        except (FileNotFoundError, ValueError):
            return []

    def publish(self, app: str, rules: List[dict]) -> None:
        import os

        tmp = self.path_for(app) + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(rules, fh, indent=1)
        os.replace(tmp, self.path_for(app))


class RulePipelineRegistry:
    """Per-rule-type (provider, publisher) pairs; absent types keep the v1
    machine-direct path (``FlowRuleApiProvider`` default semantics)."""

    def __init__(self):
        self._providers: Dict[str, DynamicRuleProvider] = {}
        self._publishers: Dict[str, DynamicRulePublisher] = {}

    def set_pipeline(self, rtype: str,
                     provider: Optional[DynamicRuleProvider],
                     publisher: Optional[DynamicRulePublisher]) -> None:
        if provider is not None:
            self._providers[rtype] = provider
        else:
            self._providers.pop(rtype, None)
        if publisher is not None:
            self._publishers[rtype] = publisher
        else:
            self._publishers.pop(rtype, None)

    def provider(self, rtype: str) -> Optional[DynamicRuleProvider]:
        return self._providers.get(rtype)

    def publisher(self, rtype: str) -> Optional[DynamicRulePublisher]:
        return self._publishers.get(rtype)
