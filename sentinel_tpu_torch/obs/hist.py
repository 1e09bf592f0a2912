"""Fixed log-bucketed latency histograms (Monarch-style in-memory
bucketed distributions: a bounded array of power-of-two buckets, cheap to
record, mergeable across processes by plain vector addition).

Bucket ``i`` covers ``(BASE_NS * 2**(i-1), BASE_NS * 2**i]`` nanoseconds
(bucket 0 is ``[0, BASE_NS]``); with ``BASE_NS = 1024`` and 40 buckets the
range runs ~1 µs → ~156 h, far past any latency the runtime can produce.
Percentiles interpolate linearly inside the landing bucket, which makes
them deterministic functions of the recorded values — pinned under the
manual clock in tests/test_obs.py.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

BASE_NS = 1024
NUM_BUCKETS = 40


def bucket_index(v_ns: int) -> int:
    """Bucket for a nanosecond value (clamped into the fixed range)."""
    v = int(v_ns)
    if v <= BASE_NS:
        return 0
    # (1024, 2048] → 1, (2048, 4096] → 2, ...  (bit_length(1024)=11)
    return min(NUM_BUCKETS - 1, (v - 1).bit_length() - 10)


def bucket_bounds_ns() -> List[int]:
    """Upper bound of each bucket, ns (the exporter/doc bucket schema)."""
    return [BASE_NS << i for i in range(NUM_BUCKETS)]


class LogHistogram:
    """Mergeable fixed-geometry histogram; thread-safe, ~O(1) record."""

    __slots__ = ("_lock", "_counts", "_total", "_sum_ns", "_max_ns")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = [0] * NUM_BUCKETS
        self._total = 0
        self._sum_ns = 0
        self._max_ns = 0

    def record(self, v_ns: int) -> None:
        v = max(0, int(v_ns))
        i = bucket_index(v)
        with self._lock:
            self._counts[i] += 1
            self._total += 1
            self._sum_ns += v
            if v > self._max_ns:
                self._max_ns = v

    def merge(self, other: "LogHistogram") -> None:
        counts, total, sum_ns, max_ns = other._state()
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._total += total
            self._sum_ns += sum_ns
            self._max_ns = max(self._max_ns, max_ns)

    def merge_counts(self, counts, sum_ns: int = 0, max_ns: int = 0) -> None:
        """Fold a raw bucket vector in (multihost aggregation payload)."""
        with self._lock:
            for i, c in enumerate(counts):
                if i < NUM_BUCKETS:
                    self._counts[i] += int(c)
                    self._total += int(c)
            self._sum_ns += int(sum_ns)
            self._max_ns = max(self._max_ns, int(max_ns))

    def _state(self):
        with self._lock:
            return list(self._counts), self._total, self._sum_ns, self._max_ns

    @property
    def count(self) -> int:
        with self._lock:
            return self._total

    def percentile(self, p: float) -> Optional[float]:
        """p ∈ (0, 1] → interpolated value in ns; None when empty."""
        counts, total, _s, max_ns = self._state()
        if total == 0:
            return None
        rank = max(1.0, p * total)       # 1-based rank of the target sample
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = 0 if i == 0 else (BASE_NS << (i - 1))
                hi = BASE_NS << i
                hi = min(hi, max_ns) if i == NUM_BUCKETS - 1 else hi
                frac = (rank - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return float(max_ns)             # pragma: no cover - rank rounding

    def percentile_ms(self, p: float) -> Optional[float]:
        v = self.percentile(p)
        return None if v is None else v / 1e6

    def snapshot(self) -> Dict:
        counts, total, sum_ns, max_ns = self._state()
        out: Dict = {"count": total, "sum_ns": sum_ns, "max_ns": max_ns,
                     "buckets": counts}
        for name, p in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            v = self.percentile(p)
            out[f"{name}_ms"] = None if v is None else v / 1e6
        return out

    def clear(self) -> None:
        with self._lock:
            self._counts = [0] * NUM_BUCKETS
            self._total = 0
            self._sum_ns = 0
            self._max_ns = 0
