"""Intra-batch segment primitives.

Port of ``sentinel_tpu/ops/segments.py``. The device pipeline admits a
whole batch in one step; to keep the reference's sequential greedy
semantics (each request sees the counters as incremented by the requests
admitted before it — ``DefaultController.canPass``) every element needs
its ARRIVAL RANK among the earlier elements with the same key (the scalar
and fast paths), or its in-segment prefix sums in a key-grouped order
(the general path: :func:`sort_by_keys` … :func:`greedy_admit`). Ranks
come from one stable sort plus a ``searchsorted`` for each group's first
position — exact, branch-free, no host sync.

Index discipline: a JAX gather clamps out-of-range indices and a
``mode="drop"`` scatter drops them; PyTorch raises (CPU) or asserts on
the device (CUDA). Every helper here clamps or masks explicitly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sort_by_keys(primary: torch.Tensor,
                 secondary: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable order of indices sorted by (primary, secondary) → int64[n]
    (batch order inside a group). Two int32 keys sort as ONE int64 key
    ``primary · 2^32 + (secondary + 2^31)``: the lexicographic order of
    the signed pair."""
    key = primary.long()
    if secondary is not None:
        key = key * (1 << 32) + (secondary.long() + (1 << 31))
    return torch.sort(key, stable=True).indices


def segment_starts(primary_sorted: torch.Tensor,
                   secondary_sorted: torch.Tensor) -> torch.Tensor:
    """bool[n]: True where a new (primary, secondary) segment begins."""
    starts = torch.ones_like(primary_sorted, dtype=torch.bool)
    starts[1:] = ((primary_sorted[1:] != primary_sorted[:-1])
                  | (secondary_sorted[1:] != secondary_sorted[:-1]))
    return starts


def segment_leader_index(starts: torch.Tensor) -> torch.Tensor:
    """For each sorted position, the index of its segment's first position
    (int64) — the reference's running max of the start positions, computed
    as segment ids (one ``cumsum``), each start written to its segment's
    slot, and one gather (``torch.cummax`` scans a 1-D tensor in one
    block: 2.85 ms per call at 2^20 elements on an H100 80GB HBM3)."""
    n = starts.shape[0]
    idx = torch.arange(n, device=starts.device)
    seg_id = torch.cumsum(starts, 0) - 1             # starts[0] is True
    first = torch.empty(n + SPARE_SLOTS, dtype=torch.long,
                        device=starts.device)
    first[torch.where(starts, seg_id, n + idx % SPARE_SLOTS)] = idx
    return first[seg_id]


def segment_prefix_sum(values_sorted: torch.Tensor, starts: torch.Tensor,
                       leader: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(exclusive, inclusive) prefix sums within each segment, in the
    values' dtype: one global ``cumsum`` minus the leader's base, as the
    JAX package computes them (int32 wraps alike; float32 is exact while
    the running total of integer values stays below 2^24)."""
    cum = torch.cumsum(values_sorted, 0, dtype=values_sorted.dtype)
    excl_global = cum - values_sorted
    base = excl_global[leader]
    return excl_global - base, cum - base


def segment_broadcast_first(values_sorted: torch.Tensor,
                            leader: torch.Tensor) -> torch.Tensor:
    """Each element gets its segment leader's value."""
    return values_sorted[leader]


def unsort(order: torch.Tensor, values_sorted: torch.Tensor) -> torch.Tensor:
    """Inverse of ``x[order]`` (``order`` a permutation, so every position
    is written once)."""
    out = torch.empty_like(values_sorted)
    out[order] = values_sorted
    return out


def greedy_admit(base: torch.Tensor, amounts: torch.Tensor,
                 limit: torch.Tensor, starts: torch.Tensor,
                 leader: torch.Tensor, iterations: int = 3) -> torch.Tensor:
    """Sequential greedy admission within segments, vectorized → bool[n]:
    element i (sorted order) is admitted iff ``base + (admitted amount of
    earlier elements in its segment) + amounts[i] <= limit[i]``, solved by
    the reference's fixed-point refinement (start from "everyone
    contributes", drop the denied, recompute; ``iterations`` passes)."""
    admitted = torch.ones_like(starts)
    for _ in range(iterations):
        excl, _ = segment_prefix_sum(torch.where(admitted, amounts, 0),
                                     starts, leader)
        admitted = base + excl + amounts <= limit
    return admitted


def ranks_by_key(key: torch.Tensor) -> torch.Tensor:
    """Per-element arrival rank within its key group → int32[n], original
    order: ``ranks[i]`` = number of earlier elements (batch order) with
    the same key. Sort stability keeps batch order inside a group."""
    return ranks_per_slot(key[:, None])[:, 0]


def ranks_per_slot(key2d: torch.Tensor) -> torch.Tensor:
    """:func:`ranks_by_key` over each SLOT column of a [B, K] key table →
    int32[B, K], as one batched stable sort over [K, B].

    Valid whenever slot columns carry DISJOINT key groups (true for the
    rule-gather tables: a rule lives at exactly one (row, slot)). A
    sentinel key shared across slots ranks per slot, not globally —
    callers never consume sentinel ranks."""
    kt = key2d.t().contiguous()                              # [K, B]
    ks, order = torch.sort(kt, dim=1, stable=True)
    first = torch.searchsorted(ks, ks, right=False)          # group start
    iota = torch.arange(kt.shape[1], device=kt.device).expand_as(kt)
    out = torch.empty_like(kt)
    out.scatter_(1, order, (iota - first).to(kt.dtype))
    return out.t()


def repeat_each(x: torch.Tensor, k: int) -> torch.Tensor:
    """``jnp.repeat(x, k)`` for a 1-D ``x`` (each element k times, in
    place order) as a broadcast view copy — ``repeat_interleave`` would
    ask the device for the output size, a host sync."""
    return x[:, None].expand(x.shape[0], k).reshape(-1)


def padded_table_gather(idx_table: torch.Tensor, rows: torch.Tensor,
                        sentinel) -> torch.Tensor:
    """Gather ``idx_table[rows]`` ([R, K] → [B, K]) where out-of-range
    rows (>= R: batch padding) yield ``sentinel`` (a negative row wraps
    once, as a JAX gather does)."""
    r = idx_table.shape[0]
    safe_rows = torch.clamp(torch.where(rows < 0, rows + r, rows),
                            0, r - 1).long()
    # a Python scalar, not a tensor made from it: that would be a copy
    # from the host, which waits for the stream
    return torch.where((rows < r)[:, None], idx_table[safe_rows],
                       int(sentinel))


#: slots past the end of a table that :func:`scatter_reduce_drop` sends
#: dropped lanes to, spread by lane index (and then slices off)
SPARE_SLOTS = 1024


def scatter_reduce_drop(dest: torch.Tensor, idx: torch.Tensor,
                        values: torch.Tensor, keep: torch.Tensor,
                        reduce: str) -> torch.Tensor:
    """``dest.at[idx].<reduce>(values, mode="drop")`` for the lanes where
    ``keep`` holds → a new tensor (``dest`` untouched; ``reduce`` as in
    ``scatter_reduce_``, the old values included). The other lanes write
    to :data:`SPARE_SLOTS` slots past the end, spread by lane index, that
    are sliced off: no live slot and no single address takes them."""
    n = dest.shape[0]
    ext = torch.cat([dest, dest.new_zeros((SPARE_SLOTS,))])
    lane = torch.arange(idx.shape[0], device=idx.device)
    tgt = torch.where(keep, idx.long(), n + lane % SPARE_SLOTS)
    return ext.scatter_reduce_(0, tgt, values, reduce=reduce)[:n]


def first_index_by_key(key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Index of each key group's FIRST element (batch order) → int32
    [num_keys], ``n`` for absent keys. Keys outside ``[0, num_keys)`` are
    dropped (negative keys wrap once, as in the JAX package)."""
    n = key.shape[0]
    k = torch.where(key < 0, key + num_keys, key)
    ok = (k >= 0) & (k < num_keys)
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    out = torch.full((num_keys,), n, dtype=torch.int32, device=key.device)
    return out.scatter_reduce_(0, torch.where(ok, k, 0).long(),
                               torch.where(ok, idx, n), reduce="amin")
