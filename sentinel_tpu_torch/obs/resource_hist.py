"""Per-resource RT histograms (the engine's ``rt_hist`` table).

Port of ``sentinel_tpu/obs/resource_hist.py``. One cumulative log-bucket
histogram row per resource row, ``int32[rows, hb]``: bucket ``0`` covers
``[0, 1]`` ms, bucket ``i`` covers ``(2**(i-1), 2**i]`` ms, the top bucket
is open above (quantile interpolation caps it at ``2**(hb-1)`` ms).
Counts only grow and reset only on row invalidation, so vectors merge by
plain addition and an interval's tail is the quantile of the difference
of two snapshots (:class:`ResourceTailTracker`).

:func:`quantiles_from_counts` is the telemetry tick's extraction on the
device; :func:`np_quantiles` its numpy mirror, in the same float32
arithmetic order. Both are exact while a row's total stays below 2^24;
above it the float32 ``cumsum`` of NumPy, JAX and PyTorch may round
differently (ROADMAP C1).

Same environment knobs as the JAX package:

* ``SENTINEL_RESOURCE_HIST_DISABLE`` — drop the table (``rt_hist`` None);
* ``SENTINEL_RESOURCE_HIST_BUCKETS`` — bucket count, clamped [8, 32].
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

RESOURCE_HIST_DISABLE_ENV = "SENTINEL_RESOURCE_HIST_DISABLE"
RESOURCE_HIST_BUCKETS_ENV = "SENTINEL_RESOURCE_HIST_BUCKETS"

DEFAULT_BUCKETS = 32
MIN_BUCKETS = 8
MAX_BUCKETS = 32            # thresholds up to 2**30 — int32-safe

#: The quantiles the per-tick extraction produces, in order: the hot
#: entries' ``rt_p{50,95,99}_ms`` fields.
QUANTILES: Tuple[float, ...] = (0.50, 0.95, 0.99)

_BOOL_FALSE = ("0", "off", "false", "disable", "disabled")


def _env_int(name: str, default: int, lo: int, hi: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return min(hi, max(lo, int(raw)))
    except ValueError:
        return default


def resource_hist_disabled(default: bool = False) -> bool:
    """``SENTINEL_RESOURCE_HIST_DISABLE`` (anything not in the false set
    reads on)."""
    raw = os.environ.get(RESOURCE_HIST_DISABLE_ENV, "")
    if not raw:
        return default
    return raw.lower() not in _BOOL_FALSE


def resource_hist_buckets(default: int = DEFAULT_BUCKETS) -> int:
    """``SENTINEL_RESOURCE_HIST_BUCKETS``, clamped to [8, 32]."""
    return _env_int(RESOURCE_HIST_BUCKETS_ENV, default, MIN_BUCKETS,
                    MAX_BUCKETS)


def engine_hist_buckets() -> int:
    """The ``EngineSpec.hist_buckets`` value for a new engine: 0 when the
    feature is disabled, else the clamped bucket count."""
    return 0 if resource_hist_disabled() else resource_hist_buckets()


# ---- geometry ---------------------------------------------------------


def bucket_thresholds_ms(hb: int) -> np.ndarray:
    """int32[hb-1] upper edges ``[1, 2, 4, ..., 2**(hb-2)]`` ms."""
    return (np.int32(1) << np.arange(hb - 1, dtype=np.int32))


def bucket_edges_ms(hb: int) -> np.ndarray:
    """float32[hb+1] bucket boundaries ``[0, 1, 2, 4, ..., 2**(hb-1)]``
    (the interpolation grid; the last edge caps the open top bucket)."""
    edges = np.zeros(hb + 1, dtype=np.float32)
    edges[1:] = np.ldexp(1.0, np.arange(hb)).astype(np.float32)
    return edges


def bucket_index(rt_ms, hb: int) -> torch.Tensor:
    """Bucket index per value → int32, ``sum(v > thresholds)``: 0 for
    v <= 1 ms, hb-1 above ``2**(hb-2)`` ms; negatives land in bucket 0.
    Any leading shape; a tensor keeps its device."""
    v = torch.as_tensor(rt_ms)
    th = torch.pow(2, torch.arange(hb - 1, dtype=torch.int32,
                                   device=v.device))  # = thresholds
    return (v[..., None] > th).sum(-1, dtype=torch.int32)


def np_bucket_index(rt_ms, hb: int) -> np.ndarray:
    """NumPy mirror of :func:`bucket_index`."""
    th = bucket_thresholds_ms(hb)
    v = np.asarray(rt_ms)
    return np.sum((v[..., None] > th).astype(np.int32), axis=-1)


# ---- quantile extraction ---------------------------------------------


def quantiles_from_counts(counts, quantiles: Sequence[float] = QUANTILES
                          ) -> torch.Tensor:
    """``int32[..., hb] → float32[..., len(quantiles)]`` ms, on the
    tensor's device.

    ``obs.hist.LogHistogram.percentile``'s rule: 1-based rank
    ``max(1, p·total)``, landing bucket = first with ``cum >= rank``,
    linear interpolation between the bucket's edges; empty rows give 0.0.
    Float32 throughout, in :func:`np_quantiles`' order (exact below 2^24
    a row, see the module docstring)."""
    c = torch.as_tensor(counts).to(torch.float32)
    dev = c.device
    hb = c.shape[-1]
    total = c.sum(-1)                                        # [...]
    cum = torch.cumsum(c, -1)                                # [..., hb]
    # the edges built on the device, exactly: 2**i from its float32 bits
    hi = ((torch.arange(hb, dtype=torch.int32, device=dev) + 127) << 23
          ).view(torch.float32)
    lo = torch.cat([torch.zeros(1, dtype=torch.float32, device=dev),
                    hi[:-1]])
    outs = []
    for p in quantiles:
        # a Python float scalar runs in float32: float32(p) * total
        rank = (total * float(np.float32(p))).clamp(min=1.0)
        idx = (cum < rank[..., None]).sum(-1, dtype=torch.int64)
        idx = torch.clamp(idx, max=hb - 1)
        cb = torch.gather(cum, -1, idx[..., None])[..., 0]
        ci = torch.gather(c, -1, idx[..., None])[..., 0]
        frac = (rank - (cb - ci)) / ci.clamp(min=1.0)
        v = lo[idx] + (hi[idx] - lo[idx]) * frac
        outs.append(torch.where(total > 0, v, 0.0))
    return torch.stack(outs, -1).to(torch.float32)


def np_quantiles(counts, quantiles: Sequence[float] = QUANTILES
                 ) -> np.ndarray:
    """NumPy mirror of :func:`quantiles_from_counts`, same float32
    arithmetic order: the host recompute of the tests and the interval
    tails of :class:`ResourceTailTracker`."""
    c = np.asarray(counts).astype(np.float32)
    hb = c.shape[-1]
    total = np.sum(c, axis=-1)
    cum = np.cumsum(c, axis=-1)
    edges = bucket_edges_ms(hb)
    lo, hi = edges[:-1], edges[1:]
    outs = []
    for p in quantiles:
        rank = np.maximum(np.float32(1.0), np.float32(p) * total)
        idx = np.sum((cum < rank[..., None]).astype(np.int32), axis=-1)
        idx = np.minimum(idx, hb - 1)
        cb = np.take_along_axis(cum, idx[..., None], axis=-1)[..., 0]
        ci = np.take_along_axis(c, idx[..., None], axis=-1)[..., 0]
        frac = (rank - (cb - ci)) / np.maximum(ci, np.float32(1.0))
        v = lo[idx] + (hi[idx] - lo[idx]) * frac
        outs.append(np.where(total > 0, v, np.float32(0.0)))
    return np.stack(outs, axis=-1).astype(np.float32)


# ---- interval tails ---------------------------------------------------


class ResourceTailTracker:
    """Interval p99 per resource from cumulative-vector deltas.

    Keeps the previous snapshot per resource name and differences
    successive vectors. A shrinking count (row invalidated and
    re-enrolled between updates) resets the baseline: the full vector is
    the interval. Names absent from an update are evicted once the map
    exceeds ``cap``."""

    def __init__(self, cap: int = 256) -> None:
        self._prev: Dict[str, np.ndarray] = {}
        self._cap = int(cap)

    def update(self, entries) -> Tuple[Tuple[str, float], ...]:
        """``[(name, cumulative counts)]`` → ``((name, interval_p99_ms),
        ...)`` for every resource with interval samples."""
        out: List[Tuple[str, float]] = []
        seen = set()
        for name, counts in entries:
            c = np.asarray(counts, dtype=np.int64)
            if c.ndim != 1 or c.shape[0] < MIN_BUCKETS:
                continue
            seen.add(name)
            prev = self._prev.get(name)
            if prev is None or prev.shape != c.shape or np.any(c < prev):
                delta = c
            else:
                delta = c - prev
            self._prev[name] = c
            if int(delta.sum()) > 0:
                p99 = float(np_quantiles(delta[None, :])[0, -1])
                out.append((name, p99))
        if len(self._prev) > self._cap:
            for stale in [n for n in self._prev if n not in seen]:
                del self._prev[stale]
                if len(self._prev) <= self._cap:
                    break
        return tuple(out)
