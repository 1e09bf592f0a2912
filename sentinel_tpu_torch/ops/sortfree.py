"""Sort-free arrival ranks, the hashed claim cascade and bucket
histograms.

Port of ``sentinel_tpu/ops/sortfree.py``. The JAX package groups the
general path's (rule, stat-row) segments without a sort, because sorts
are expensive on the TPU:

1. the **claim cascade** (:func:`build_pair_plan` / :func:`build_key_plan`):
   over 3 rounds of independent multiplicative hashes, every unsettled key
   scatter-mins its coordinates into its hashed bucket of a ``2^bits``
   table and settles where it reads them back — so the effective bucket
   ``round · T + bucket`` is injective over distinct keys, and keys still
   unsettled raise ``overflow`` (the caller then takes the sorted order);
2. **counting order** (:func:`counting_order`): the stable counting-sort
   permutation ``offsets[bucket] + rank``, whose bucket histogram goes
   through the :func:`ops.scatter_add.scatter_add` seam (the kernel).

The cascade, its buckets and its ``overflow_count`` are the reference's,
bit for bit: the uint32 hash arithmetic is done in int64 masked to 32
bits (:func:`_mul32` keeps every product below 2^49, so nothing relies on
int64 wrap-around). Ranks inside a bucket are the port's: one stable
``torch.sort`` (:mod:`ops.segments`), where the JAX package runs a
``lax.scan`` of dense chunk compares — the same numbers by definition
("earlier elements in my bucket, batch order"), so ``SENTINEL_SORTFREE_
CHUNK``, which only sizes that scan, has no counterpart here.

Where the reference branches with ``lax.cond(overflow, sorted, hashed)``
the port computes both and selects with ``torch.where`` on the device:
no host sync decides a branch.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from sentinel_tpu_torch.ops import scatter_add as sa
from sentinel_tpu_torch.ops import segments as seg

# Claim rounds and the odd 32-bit mixing constants (one (A, B) pair per
# round) of the reference cascade.
ROUNDS = 3
_HASH_A = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)
_HASH_B = (0x27D4EB2F, 0x165667B1, 0x7FEB352D)
_HASH_MIX = 0x2C1B3C6D

_I32_MAX = 2 ** 31 - 1
_M32 = 0xFFFFFFFF


def table_bits(n: int) -> int:
    """Claim-table size exponent for an n-element batch: ~2 buckets per
    element, clamped to [6, 18]; ``SENTINEL_SORTFREE_BITS`` overrides
    (clamped to [1, 18]; an unparsable value is ignored) — the
    collision-forcing tests pin it tiny to take the overflow branch. Read
    at every call, as the reference reads it at every trace."""
    raw = os.environ.get("SENTINEL_SORTFREE_BITS", "")
    if raw:
        try:
            return max(1, min(int(raw), 18))
        except ValueError:
            pass
    bits = 1
    while (1 << bits) < 2 * max(n, 2):
        bits += 1
    return max(6, min(bits, 18))


class BucketPlan(NamedTuple):
    """Output of the claim cascade: ``bucket`` int32[n] (injective over
    distinct keys unless ``overflow``), the reserved last bucket
    ``num_buckets - 1`` holding the caller's sentinel key."""

    bucket: torch.Tensor          # int32[n]
    overflow: torch.Tensor        # bool scalar
    overflow_count: torch.Tensor  # int32 scalar — unsettled elements
    num_buckets: int              # ROUNDS * 2^bits + 1


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """``(u * c) mod 2^32`` for int64 ``u`` in [0, 2^32) and a constant
    ``c`` in [0, 2^32), through 16-bit halves of ``c`` (no product
    reaches 2^49)."""
    lo = u * (c & 0xFFFF)
    hi = ((u * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _u32(k: torch.Tensor) -> torch.Tensor:
    """int32 → its uint32 bit pattern, as int64."""
    return k.long() & _M32


def _bucket_of(mix: torch.Tensor, bits: int) -> torch.Tensor:
    """The reference's avalanche: ``((mix ^ mix >> 15) * MIX) >> (32 -
    bits)`` in uint32 (``mix`` int64 in [0, 2^32)) → int32."""
    h = _mul32(mix ^ (mix >> 15), _HASH_MIX)
    return (h >> (32 - bits)).to(torch.int32)


def _claim_min(t: int, tgt: torch.Tensor, values: torch.Tensor
               ) -> torch.Tensor:
    """``full((t,), I32_MAX).at[tgt].min(values, mode="drop")``, a
    target ``>= t`` (a settled element) dropped."""
    table = torch.full((t,), _I32_MAX, dtype=torch.int32,
                       device=values.device)
    return seg.scatter_reduce_drop(table, tgt, values, tgt < t, "amin")


def _cascade(bits: int, sentinel_mask: torch.Tensor, round_bucket,
             claim_and_win) -> BucketPlan:
    """Shared cascade body: per round, unsettled elements hash, claim and
    (winners) freeze ``r · T + bucket_r``; settled elements sit out."""
    t = 1 << bits
    settled = sentinel_mask
    bucket = torch.where(sentinel_mask, ROUNDS * t, 0).to(torch.int32)
    for r in range(ROUNDS):
        b_r = round_bucket(r)
        tgt = torch.where(settled, t, b_r)
        win = ~settled & claim_and_win(tgt, b_r)
        bucket = torch.where(win, r * t + b_r, bucket)
        settled = settled | win
    overflow_count = (~settled).sum(dtype=torch.int32)
    return BucketPlan(bucket=bucket, overflow=overflow_count > 0,
                      overflow_count=overflow_count,
                      num_buckets=ROUNDS * t + 1)


def build_pair_plan(k1: torch.Tensor, k2: torch.Tensor,
                    sentinel_mask: torch.Tensor, bits: int) -> BucketPlan:
    """Claim cascade over int32 PAIR keys (k1, k2) — the general path's
    (rule, stat-row) segment key. Two scatter-mins claim each bucket; an
    element wins iff it reads BOTH its coordinates back, so at most one
    distinct key settles per (round, bucket)."""
    t = 1 << bits
    u1, u2 = _u32(k1), _u32(k2)

    def round_bucket(r: int) -> torch.Tensor:
        return _bucket_of((_mul32(u1, _HASH_A[r]) + _mul32(u2, _HASH_B[r]))
                          & _M32, bits)

    def claim_and_win(tgt, b_r):
        claim1 = _claim_min(t, tgt, k1)
        claim2 = _claim_min(t, tgt, k2)
        b = b_r.long()
        return (claim1[b] == k1) & (claim2[b] == k2)

    return _cascade(bits, sentinel_mask, round_bucket, claim_and_win)


def build_key_plan(key: torch.Tensor, sentinel_mask: torch.Tensor,
                   bits: int, groups: int = 1) -> BucketPlan:
    """Claim cascade over single int32 keys (the fast path's composite
    key). ``key`` may be ``[groups, n]``: each row runs its own cascade
    over its own claim table (the reference's ``vmap`` over slot
    columns); ``overflow_count`` is then the total over rows."""
    t = 1 << bits
    flat = key.reshape(-1)
    u = _u32(flat)
    n = flat.shape[0]
    idx = torch.arange(n, device=key.device)
    # row g's claims live in table slots [g·T, (g+1)·T)
    row_base = (idx // max(n // groups, 1)) * t

    def round_bucket(r: int) -> torch.Tensor:
        return _bucket_of((_mul32(u, _HASH_A[r]) + _HASH_B[r]) & _M32, bits)

    def claim_and_win(tgt, b_r):
        gt = torch.where(tgt >= t, groups * t, tgt + row_base)
        claim = _claim_min(groups * t, gt, flat)
        return claim[(b_r + row_base).long()] == flat

    plan = _cascade(bits, sentinel_mask.reshape(-1), round_bucket,
                    claim_and_win)
    return plan._replace(bucket=plan.bucket.reshape(key.shape))


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


def counting_order(bucket: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Stable counting-sort permutation by bucket → int64[n]: buckets
    contiguous, batch order kept inside each — a drop-in for
    :func:`ops.segments.sort_by_keys` when buckets are injective over the
    segment keys (the downstream segment math is permutation-invariant
    across segments). With an overflowed plan the positions may collide;
    the caller discards that order."""
    n = bucket.shape[0]
    hist = bucket_histogram(bucket, num_buckets)
    offsets = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    pos = (offsets[bucket.long()] + scatter_ranks(bucket, num_buckets)).long()
    order = torch.zeros(n, dtype=torch.long, device=bucket.device)
    order[pos] = torch.arange(n, device=bucket.device)
    return order


def ranks2d_ident(key2d: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Per-slot arrival ranks for a SMALL key space (the scalar path:
    key = rule id in ``[0, num_keys)``) → int32[B, K]."""
    return seg.ranks_per_slot(key2d)


def ranks2d_hashed(key2d: torch.Tensor, sentinel_value: int, bits: int):
    """Per-slot arrival ranks for a LARGE key space (the fast path's
    composite key) → (ranks int32[B, K], overflow_count int32 scalar).

    Each slot column runs its own claim cascade (the shared sentinel key
    goes to the reserved bucket); the ranks are arrival ranks within each
    column's buckets. With ``overflow_count > 0`` they are not valid and
    the caller selects :func:`ops.segments.ranks_per_slot` instead."""
    kt = key2d.t().contiguous()                              # [K, B]
    plan = build_key_plan(kt, kt == sentinel_value, bits,
                          groups=kt.shape[0])
    return seg.ranks_per_slot(plan.bucket.t()), plan.overflow_count
