"""Host-side batch staging helpers.

Port of ``sentinel_tpu/core/batching.py``: batches are padded to powers of
two (padding rows ``== R``, ``valid`` False). The padding changes no
verdict and no counter; it keeps the padded lanes' effect on the
per-rule sentinel rows (which even an all-padding step touches) identical
to the JAX package's, and keeps a few reused batch shapes.
"""

from __future__ import annotations

import numpy as np


def pad_pow2(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor)."""
    b = floor
    while b < n:
        b *= 2
    return b


def pad_to(arr, b: int, fill, dtype) -> np.ndarray:
    """Copy ``arr`` (``[n, ...]``) into a ``[b, ...]`` array padded with
    ``fill``."""
    out = np.full((b,) + np.shape(arr)[1:], fill, dtype)
    n = arr.shape[0] if hasattr(arr, "shape") else len(arr)
    out[:n] = arr
    return out


def pad_into(dst: np.ndarray, arr, fill) -> np.ndarray:
    """In-place :func:`pad_to` into a preallocated staging buffer: fill
    ``dst[:n]`` from ``arr`` and ``dst[n:]`` with ``fill`` → ``dst``. The
    caller owns the reuse discipline (the runtime's staging ring does not
    rewrite a slot while a dispatch built from it may still read it)."""
    n = arr.shape[0] if hasattr(arr, "shape") else len(arr)
    dst[:n] = arr
    if n < dst.shape[0]:
        dst[n:] = fill
    return dst
