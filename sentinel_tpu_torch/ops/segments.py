"""Intra-batch segment primitives (the scalar path's subset).

Port of ``sentinel_tpu/ops/segments.py``. The device pipeline admits a
whole batch in one step; to keep the reference's sequential greedy
semantics (each request sees the counters as incremented by the requests
admitted before it — ``DefaultController.canPass``) every element needs
its ARRIVAL RANK among the earlier elements with the same key. Here that
rank comes from one stable sort plus a ``searchsorted`` for each group's
first position — exact, branch-free, no host sync.

Index discipline: a JAX gather clamps out-of-range indices and a
``mode="drop"`` scatter drops them; PyTorch raises (CPU) or asserts on
the device (CUDA). Every helper here clamps or masks explicitly.
"""

from __future__ import annotations

import torch


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
    return torch.where((rows < r)[:, None], idx_table[safe_rows],
                       torch.as_tensor(sentinel, dtype=idx_table.dtype,
                                       device=idx_table.device))


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
