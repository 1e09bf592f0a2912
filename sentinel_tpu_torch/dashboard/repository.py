"""In-memory stores: metrics ring + rule repositories (reference
``sentinel-dashboard/.../repository/metric/InMemoryMetricsRepository.java:40-63``
and ``repository/rule/InMemoryRuleRepositoryAdapter.java``).

Metrics are kept per ``app → resource → ordered {ts → MetricEntity}`` with a
5-minute retention window (``MAX_METRIC_LIVE_TIME_MS``); rules live in a
per-type store with a global auto-increment id, mirroring the dashboard's
``InMemFlowRuleStore`` family.

The PyTorch port's own copy of ``sentinel_tpu/dashboard/repository.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

MAX_METRIC_LIVE_TIME_MS = 5 * 60 * 1000   # InMemoryMetricsRepository.java:43


@dataclasses.dataclass
class MetricEntity:
    app: str = ""
    timestamp: int = 0          # ms, whole second
    resource: str = ""
    pass_qps: int = 0
    block_qps: int = 0
    success_qps: int = 0
    exception_qps: int = 0
    rt: float = 0.0             # avg rt for the second
    count: int = 0              # number of machines aggregated

    def to_dict(self) -> dict:
        return {
            "app": self.app, "timestamp": self.timestamp,
            "resource": self.resource, "passQps": self.pass_qps,
            "blockQps": self.block_qps, "successQps": self.success_qps,
            "exceptionQps": self.exception_qps, "rt": round(self.rt, 2),
            "count": self.count,
        }


class InMemoryMetricsRepository:
    def __init__(self, *, retention_ms: int = MAX_METRIC_LIVE_TIME_MS):
        self._lock = threading.Lock()
        self.retention_ms = retention_ms
        # app -> resource -> OrderedDict[ts -> MetricEntity]
        self._data: Dict[str, Dict[str, "OrderedDict[int, MetricEntity]"]] = {}

    def save(self, e: MetricEntity, now_ms: Optional[int] = None) -> None:
        now = int(time.time() * 1000) if now_ms is None else now_ms
        with self._lock:
            ring = (self._data.setdefault(e.app, {})
                    .setdefault(e.resource, OrderedDict()))
            old = ring.get(e.timestamp)
            if old is not None:
                # second machine reporting the same second: accumulate
                total = old.count + e.count if (old.count and e.count) else 0
                old.rt = ((old.rt * old.count + e.rt * e.count) / total
                          if total else max(old.rt, e.rt))
                old.pass_qps += e.pass_qps
                old.block_qps += e.block_qps
                old.success_qps += e.success_qps
                old.exception_qps += e.exception_qps
                old.count = total or old.count
            else:
                ring[e.timestamp] = e
            cutoff = now - self.retention_ms
            while ring and next(iter(ring)) < cutoff:
                ring.popitem(last=False)

    def save_all(self, entities: List[MetricEntity],
                 now_ms: Optional[int] = None) -> None:
        for e in entities:
            self.save(e, now_ms)

    def query(self, app: str, resource: str, start_ms: int,
              end_ms: int) -> List[MetricEntity]:
        with self._lock:
            ring = self._data.get(app, {}).get(resource, OrderedDict())
            return [e for ts, e in ring.items() if start_ms <= ts <= end_ms]

    def list_resources(self, app: str) -> List[str]:
        """Resources of ``app`` sorted by recent pass+block volume desc
        (``listResourcesOfApp`` — last minute, then alphabetical)."""
        with self._lock:
            rings = self._data.get(app, {})
            volume = {}
            for res, ring in rings.items():
                if not ring:
                    continue
                last_ts = next(reversed(ring))
                cutoff = last_ts - 60_000
                volume[res] = sum(e.pass_qps + e.block_qps
                                  for ts, e in ring.items() if ts >= cutoff)
        return sorted(volume, key=lambda r: (-volume[r], r))


@dataclasses.dataclass
class RuleEntity:
    id: int = 0
    app: str = ""
    ip: str = ""
    port: int = 0
    rule: Dict[str, Any] = dataclasses.field(default_factory=dict)
    gmt_create: int = 0

    def to_dict(self) -> dict:
        d = dict(self.rule)
        d.update(id=self.id, app=self.app, ip=self.ip, port=self.port)
        return d


class RuleRepository:
    """One store per rule type; ids are unique across types (shared counter
    like the dashboard's ``InMemoryRuleRepositoryAdapter`` ids)."""

    _ids = itertools.count(1)
    _ids_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_id: Dict[int, RuleEntity] = {}

    @classmethod
    def next_id(cls) -> int:
        with cls._ids_lock:
            return next(cls._ids)

    def save(self, entity: RuleEntity) -> RuleEntity:
        with self._lock:
            if not entity.id:
                entity.id = self.next_id()
            if not entity.gmt_create:
                entity.gmt_create = int(time.time() * 1000)
            self._by_id[entity.id] = entity
            return entity

    def save_all(self, entities: List[RuleEntity]) -> List[RuleEntity]:
        return [self.save(e) for e in entities]

    def replace_app(self, app: str, entities: List[RuleEntity]) -> List[RuleEntity]:
        """Swap the full rule set of one app (used when re-pulling from a
        machine: ``FlowControllerV1.apiQueryMachineRules`` saveAll path)."""
        with self._lock:
            for rid in [i for i, e in self._by_id.items() if e.app == app]:
                del self._by_id[rid]
        return self.save_all(entities)

    def find(self, rule_id: int) -> Optional[RuleEntity]:
        with self._lock:
            return self._by_id.get(rule_id)

    def find_by_app(self, app: str) -> List[RuleEntity]:
        with self._lock:
            return sorted((e for e in self._by_id.values() if e.app == app),
                          key=lambda e: e.id)

    def delete(self, rule_id: int) -> Optional[RuleEntity]:
        with self._lock:
            return self._by_id.pop(rule_id, None)
