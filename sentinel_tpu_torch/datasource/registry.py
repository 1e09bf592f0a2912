"""Writable-datasource registry (reference
``WritableDataSourceRegistry.java``): the ``setRules`` command persists a
successful in-memory load through the registered writable source for that
rule type (``ModifyRulesCommandHandler.java:47-77``).

The reference's registry is JVM-global static state; here the registry is an
ordinary object so multiple :class:`~sentinel_tpu_torch.runtime.Sentinel` instances
in one process don't cross-write each other's rule files — a module-level
``default_registry`` keeps the one-instance case as convenient as the
reference.

The PyTorch port's own copy of ``sentinel_tpu/datasource/registry.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from sentinel_tpu_torch.datasource.base import WritableDataSource


class WritableDataSourceRegistry:
    def __init__(self) -> None:
        self._sources: Dict[str, WritableDataSource] = {}
        self._lock = threading.Lock()

    def register(self, rule_type: str, source: WritableDataSource) -> None:
        with self._lock:
            self._sources[rule_type] = source

    def get(self, rule_type: str) -> Optional[WritableDataSource]:
        with self._lock:
            return self._sources.get(rule_type)

    def write_if_registered(self, rule_type: str, rules: List[Any]) -> bool:
        src = self.get(rule_type)
        if src is None:
            return False
        src.write(rules)
        return True

    def clear(self) -> None:
        with self._lock:
            self._sources.clear()


default_registry = WritableDataSourceRegistry()
