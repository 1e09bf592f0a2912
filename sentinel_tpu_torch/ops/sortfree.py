"""Sort-free arrival ranks and bucket histograms (the scalar path's
subset).

Port of ``sentinel_tpu/ops/sortfree.py``. The JAX package ranks arrivals
without a sort — a ``lax.scan`` over chunks carrying per-bucket running
counts, with a dense [m, m] triangular compare inside each chunk — because
sorts are expensive on the TPU. On the GPU a stable radix sort is cheap
and exact, so :func:`scatter_ranks` and :func:`ranks2d_ident` here return
the same ranks through :mod:`ops.segments`' sort (identical by
definition: both are "earlier elements in my bucket, batch order"). The
hashed claim cascade (``build_pair_plan``/``build_key_plan``) belongs to
the general path and is a later slice.
"""

from __future__ import annotations

import torch

from sentinel_tpu_torch.ops import scatter_add as sa
from sentinel_tpu_torch.ops import segments as seg


def bucket_histogram(bucket: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Per-bucket element counts → int32[num_buckets], through the
    :func:`ops.scatter_add.scatter_add` seam (one event lane)."""
    counters = torch.zeros((num_buckets, 1), dtype=torch.int32,
                           device=bucket.device)
    ones = torch.ones_like(bucket, dtype=torch.int32)
    return sa.scatter_add(counters, bucket.to(torch.int32),
                          torch.zeros_like(ones), ones)[:, 0]


def scatter_ranks(bucket: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Arrival rank within bucket, ORIGINAL order → int32[n]. Buckets
    must lie in ``[0, num_buckets)`` (the JAX scan gives out-of-range
    buckets chunk-dependent ranks that no caller reads)."""
    return seg.ranks_by_key(bucket)


def ranks2d_ident(key2d: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Per-slot arrival ranks for a SMALL key space (the scalar path:
    key = rule id in ``[0, num_keys)``) → int32[B, K]."""
    return seg.ranks_per_slot(key2d)
