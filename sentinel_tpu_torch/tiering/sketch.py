"""Conservative-update count-min sketch over resource ROW ids (device).

Port of ``sentinel_tpu/tiering/sketch.py``: hot-set discovery for the
tiered state machine (Cormode & Muthukrishnan 2005, conservative update:
a counter only rises to the new minimum estimate). The table is ``SR``
hash rows × ``W = 2**bits`` int32 buckets, updated from each decide
batch's row array under the engine lock with no wait on the device; the
tiering ticker reads estimates back asynchronously.

The update is a scatter-max of ``N`` batch elements into ``[SR, W]``.
The reference keeps three forms of it behind ``SKETCH_IMPLS`` and ships
XLA's scatter after an A/B on the TPU; the one-hot and segment forms were
that A/B's foils on the TPU and are not ported. Here the one form is
``scatter_reduce_(amax)`` through
:func:`~sentinel_tpu_torch.ops.segments.scatter_reduce_drop`: padding
lanes (target 0, a no-op under max since counts are >= 0) all hash from
the same pad row to the same ``SR`` buckets, so they go to spread spare
slots instead of piling onto those addresses.

Hash family: multiply-shift over odd 32-bit constants,
``h_s(x) = ((x · C_s) mod 2^32) >>> 15 & (W − 1)`` with a LOGICAL shift.
PyTorch's ``>>`` on int32 is arithmetic and would give other buckets for
products with the top bit set once ``bits > 17``, so the product is
formed in int64 and masked to its low 32 bits before the shift.

Decay (ticker): ``c -= max(c >>> DECAY_SHIFT, min(c, 1))`` so cold
counters reach zero. Overflow: :func:`update_sketch` halves the whole
table when any target crosses :data:`OVERFLOW_CAP`, chosen on the device
with ``torch.where`` (the flag is never read on the host in a decide).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sentinel_tpu_torch.ops import segments as seg

DEFAULT_BITS = 12        # W = 4096 buckets per hash row
DEFAULT_ROWS = 4         # SR hash rows
DECAY_SHIFT = 3          # per-tick decay: c -= c >> 3 (~12%/tick)
OVERFLOW_CAP = 1 << 30   # halve the table past this estimate

# odd multiply-shift constants (Knuth/Dietzfelbinger family); 8 rows max
_HASH_CONSTS = np.array(
    [0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F,
     0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09], np.uint32)

_LOW32 = (1 << 32) - 1


def init_sketch(sketch_rows: int = DEFAULT_ROWS, bits: int = DEFAULT_BITS,
                device="cpu") -> torch.Tensor:
    """Fresh zero table int32[SR, W]."""
    sketch_rows = max(1, min(int(sketch_rows), len(_HASH_CONSTS)))
    return torch.zeros((sketch_rows, 1 << int(bits)), dtype=torch.int32,
                       device=device)


def _shift_right_logical(x: torch.Tensor, s: int) -> torch.Tensor:
    """``lax.shift_right_logical`` of an int32 tensor by ``s`` >= 1."""
    return ((x.to(torch.int64) & _LOW32) >> s).to(torch.int32)


def _bucket_idx(counts: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """int64[SR, N] bucket per (hash row, item): multiply-shift."""
    sr, w = counts.shape
    x = items.to(torch.int64)
    # Python-int constants: a tensor built from host data would be a
    # host→device copy on every call
    return torch.stack([((x * int(c)) & _LOW32) >> 15
                        for c in _HASH_CONSTS[:sr]]) & (w - 1)


def _estimates(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Count-min read: the min over hash rows of the addressed buckets."""
    sr = counts.shape[0]
    rows = torch.arange(sr, device=counts.device)[:, None]
    return counts[rows, idx].amin(dim=0)                       # [N]


def _update_scatter(counts: torch.Tensor, idx: torch.Tensor,
                    target: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Scatter-max of ``target`` into the addressed buckets (the
    reference's ``.at[rr, idx].max``) → a new table. Invalid lanes carry
    target 0, a no-op under max over counts >= 0: they are routed to
    spare slots rather than written."""
    sr, w = counts.shape
    flat_idx = (torch.arange(sr, device=counts.device)[:, None] * w
                + idx).reshape(-1)
    flat_val = target[None, :].expand(sr, -1).reshape(-1)
    keep = valid[None, :].expand(sr, -1).reshape(-1)
    out = seg.scatter_reduce_drop(counts.reshape(-1), flat_idx, flat_val,
                                  keep, "amax")
    return out.reshape(sr, w)


#: the shipped scatter-max form (the reference's A/B foils are not ported)
SKETCH_IMPLS = {"scatter": _update_scatter}
DEFAULT_IMPL = "scatter"


def update_sketch(counts: torch.Tensor, items: torch.Tensor,
                  valid: torch.Tensor, impl: str = DEFAULT_IMPL
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conservative update: each valid item raises its buckets to
    ``min-estimate + 1`` (never higher) → ``(counts', overflow)``, a new
    table and a 0-d bool tensor (any target crossed :data:`OVERFLOW_CAP`;
    the table is then halved here). Duplicate items within one batch
    under-count by design. Nothing waits on the device."""
    idx = _bucket_idx(counts, items)                           # [SR, N]
    est = _estimates(counts, idx)                              # [N]
    valid = valid.to(torch.bool)
    target = torch.where(valid, est + 1, 0).to(torch.int32)
    counts = SKETCH_IMPLS[impl](counts, idx, target, valid)
    overflow = (target >= OVERFLOW_CAP).any()
    counts = torch.where(overflow, halve_sketch(counts), counts)
    return counts, overflow


def decay_sketch(counts: torch.Tensor) -> torch.Tensor:
    """Per-tick exponential decay (recency weighting); nonzero counters
    lose at least 1 a tick."""
    dec = torch.maximum(_shift_right_logical(counts, DECAY_SHIFT),
                        torch.clamp(counts, max=1))
    return counts - dec


def halve_sketch(counts: torch.Tensor) -> torch.Tensor:
    return _shift_right_logical(counts, 1)


def estimate_all(counts: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Estimates for every main-table row id ``[0, n_rows)`` → int32[R],
    a fresh tensor (the ticker's demotion-ranking read)."""
    items = torch.arange(n_rows, dtype=torch.int32, device=counts.device)
    return _estimates(counts, _bucket_idx(counts, items))


def tick_read(counts: torch.Tensor, n_rows: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ticker read: decay, then estimate every row → ``(counts',
    est)``. The self-dispatched tick and the single-dispatch epilogue of
    a fused serving step both run this function."""
    counts = decay_sketch(counts)
    return counts, estimate_all(counts, n_rows)


__all__ = [
    "DEFAULT_BITS", "DEFAULT_ROWS", "DECAY_SHIFT", "OVERFLOW_CAP",
    "SKETCH_IMPLS", "DEFAULT_IMPL", "init_sketch", "update_sketch",
    "decay_sketch", "halve_sketch", "estimate_all", "tick_read",
]
