"""Per-resource RT histogram geometry (the engine's ``rt_hist`` table).

Port of the part of ``sentinel_tpu/obs/resource_hist.py`` the engine step
needs: the bucket thresholds, the traced bucket index and the
``engine_hist_buckets`` knob. One cumulative log-bucket histogram row per
resource row, ``int32[rows, hb]``: bucket ``0`` covers ``[0, 1]`` ms,
bucket ``i`` covers ``(2**(i-1), 2**i]`` ms, the top bucket is open
above. Same environment knobs as the JAX package:

* ``SENTINEL_RESOURCE_HIST_DISABLE`` — drop the table (``rt_hist`` None);
* ``SENTINEL_RESOURCE_HIST_BUCKETS`` — bucket count, clamped [8, 32].
"""

from __future__ import annotations

import os

import numpy as np
import torch

RESOURCE_HIST_DISABLE_ENV = "SENTINEL_RESOURCE_HIST_DISABLE"
RESOURCE_HIST_BUCKETS_ENV = "SENTINEL_RESOURCE_HIST_BUCKETS"

DEFAULT_BUCKETS = 32

_BOOL_FALSE = ("0", "off", "false", "disable", "disabled")


def resource_hist_disabled(default: bool = False) -> bool:
    """``SENTINEL_RESOURCE_HIST_DISABLE`` (anything not in the false set
    reads on)."""
    raw = os.environ.get(RESOURCE_HIST_DISABLE_ENV, "")
    if not raw:
        return default
    return raw.lower() not in _BOOL_FALSE


def resource_hist_buckets(default: int = DEFAULT_BUCKETS) -> int:
    """``SENTINEL_RESOURCE_HIST_BUCKETS``, clamped to [8, 32]."""
    raw = os.environ.get(RESOURCE_HIST_BUCKETS_ENV, "")
    if not raw:
        return default
    try:
        return min(32, max(8, int(raw)))
    except ValueError:
        return default


def engine_hist_buckets() -> int:
    """The ``EngineSpec.hist_buckets`` value for a new engine: 0 when the
    feature is disabled, else the clamped bucket count."""
    return 0 if resource_hist_disabled() else resource_hist_buckets()


def bucket_thresholds_ms(hb: int) -> np.ndarray:
    """int32[hb-1] upper edges ``[1, 2, 4, ..., 2**(hb-2)]`` ms."""
    return (np.int32(1) << np.arange(hb - 1, dtype=np.int32))


def bucket_index(rt_ms: torch.Tensor, hb: int) -> torch.Tensor:
    """Bucket index per value → int32, ``sum(v > thresholds)``: 0 for
    v <= 1 ms, hb-1 above ``2**(hb-2)`` ms; negatives land in bucket 0."""
    th = torch.pow(2, torch.arange(hb - 1, dtype=torch.int32,
                                   device=rt_ms.device))  # = thresholds
    return (rt_ms[..., None] > th).sum(-1, dtype=torch.int32)
