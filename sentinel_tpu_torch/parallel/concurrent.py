"""Global concurrency tokens: cluster-wide in-flight call limiting.

Reference (``sentinel-cluster-server-default``):

* ``ConcurrentClusterFlowChecker`` (``flow/ConcurrentClusterFlowChecker.java:26-80``):
  ``acquire`` — if ``nowCalls + acquireCount > calcGlobalThreshold(rule)``
  (count, or count × connectedCount for AVG_LOCAL) → BLOCKED; else add and
  mint a ``TokenCacheNode`` with a fresh tokenId; ``release(tokenId)`` —
  missing node → ALREADY_RELEASE, else decrement → RELEASE_OK.
* ``TokenCacheNodeManager`` (ConcurrentLinkedHashMap of tokenId → node) +
  ``RegularExpireStrategy`` (scheduled sweep deleting expired borrows and
  returning their permits) — **the only lease/expiry GC in the system**
  (SURVEY §5): it reclaims tokens from clients that died mid-call.

Placement: concurrency state is *host* state by design. Unlike the
windowed QPS counters (dense tensors, device), ``nowCalls`` is a handful of
scalars mutated by acquire/release pairs at call rate, and the lease table is
a dict with TTLs — the reference itself serializes acquires on a lock
(``synchronized (nowCalls)``). The host runtime owns it; the device engine
owns the windowed statistics. Sweeps are vectorized over numpy lease arrays.

The PyTorch port's own copy of ``sentinel_tpu/parallel/concurrent.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sentinel_tpu_torch.parallel.cluster import (
    STATUS_ALREADY_RELEASE, STATUS_BLOCKED, STATUS_FAIL, STATUS_NO_RULE_EXISTS,
    STATUS_OK, STATUS_RELEASE_OK, THRESHOLD_GLOBAL,
)

# ClusterFlowConfig.resourceTimeout default (cluster/flow/rule/ClusterFlowConfig.java)
DEFAULT_RESOURCE_TIMEOUT_MS = 2000


@dataclasses.dataclass
class ConcurrentFlowRule:
    """Concurrency-grade cluster rule (FlowRule with GRADE_THREAD + cluster
    config: flowId, thresholdType, resourceTimeout)."""

    flow_id: int
    count: float
    threshold_type: int = THRESHOLD_GLOBAL
    resource_timeout_ms: int = DEFAULT_RESOURCE_TIMEOUT_MS


@dataclasses.dataclass
class TokenLease:
    """TokenCacheNode: one outstanding borrow."""

    token_id: int
    flow_id: int
    acquire: int
    client_address: str
    expire_at_ms: int


class ConcurrentTokenManager:
    """CurrentConcurrencyManager + TokenCacheNodeManager + expire sweep."""

    def __init__(self, *, connected_count: int = 1):
        self._lock = threading.Lock()
        self._rules: Dict[int, ConcurrentFlowRule] = {}
        self._now_calls: Dict[int, int] = {}
        self._leases: Dict[int, TokenLease] = {}
        self._token_ids = itertools.count(1)
        self._connected: Dict[int, int] = {}
        self._default_connected = max(1, connected_count)

    # ------------------------------------------------------------------
    def load_rules(self, rules: Sequence[ConcurrentFlowRule]) -> None:
        """Replace the rule set; nowCalls of surviving flows are preserved
        (CurrentConcurrencyManager keeps counters across rule updates)."""
        with self._lock:
            keep = {r.flow_id for r in rules}
            self._rules = {r.flow_id: r for r in rules}
            for fid in list(self._now_calls):
                if fid not in keep:
                    del self._now_calls[fid]
            for fid in keep:
                self._now_calls.setdefault(fid, 0)

    def set_connected_count(self, flow_id: int, count: int) -> None:
        with self._lock:
            self._connected[flow_id] = max(1, count)

    def _threshold(self, rule: ConcurrentFlowRule) -> float:
        if rule.threshold_type == THRESHOLD_GLOBAL:
            return rule.count
        conn = self._connected.get(rule.flow_id, self._default_connected)
        return rule.count * conn

    # ------------------------------------------------------------------
    def acquire(self, flow_id: int, acquire: int, *, client_address: str = "",
                now_ms: int) -> Tuple[int, int]:
        """→ (status, token_id). OK mints a lease; BLOCKED/FAIL → token 0."""
        if acquire <= 0:
            return STATUS_FAIL, 0
        with self._lock:
            rule = self._rules.get(flow_id)
            if rule is None or flow_id not in self._now_calls:
                return STATUS_FAIL, 0
            if self._now_calls[flow_id] + acquire > self._threshold(rule):
                return STATUS_BLOCKED, 0
            self._now_calls[flow_id] += acquire
            tid = next(self._token_ids)
            self._leases[tid] = TokenLease(
                token_id=tid, flow_id=flow_id, acquire=acquire,
                client_address=client_address,
                expire_at_ms=now_ms + rule.resource_timeout_ms)
            return STATUS_OK, tid

    def release(self, token_id: int) -> int:
        """→ status (RELEASE_OK / ALREADY_RELEASE / NO_RULE_EXISTS)."""
        with self._lock:
            lease = self._leases.pop(token_id, None)
            if lease is None:
                return STATUS_ALREADY_RELEASE
            if lease.flow_id not in self._rules:
                return STATUS_NO_RULE_EXISTS
            self._now_calls[lease.flow_id] = max(
                0, self._now_calls.get(lease.flow_id, 0) - lease.acquire)
            return STATUS_RELEASE_OK

    # ------------------------------------------------------------------
    def sweep_expired(self, *, now_ms: int) -> int:
        """RegularExpireStrategy: reclaim permits from expired leases.

        Vectorized: one pass over lease arrays, then dict surgery on the
        expired subset. Returns the number of leases reclaimed."""
        with self._lock:
            if not self._leases:
                return 0
            tids = np.fromiter(self._leases, np.int64, count=len(self._leases))
            exp = np.fromiter((l.expire_at_ms for l in self._leases.values()),
                              np.int64, count=len(self._leases))
            dead = tids[exp <= now_ms]
            for tid in dead.tolist():
                lease = self._leases.pop(tid)
                if lease.flow_id in self._now_calls:
                    self._now_calls[lease.flow_id] = max(
                        0, self._now_calls[lease.flow_id] - lease.acquire)
            return int(dead.size)

    # ------------------------------------------------------------------
    def now_calls(self, flow_id: int) -> int:
        with self._lock:
            return self._now_calls.get(flow_id, 0)

    def lease_count(self) -> int:
        with self._lock:
            return len(self._leases)

    def leases_of(self, client_address: str) -> List[TokenLease]:
        with self._lock:
            return [l for l in self._leases.values()
                    if l.client_address == client_address]
