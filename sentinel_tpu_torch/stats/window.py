"""Sliding-window counters as dense tensors — the LeapArray analog.

Port of ``sentinel_tpu/stats/window.py`` (the admission paths' subset). One
tensor per concern instead of one LeapArray object per resource:

* ``counters: int32[R, B, E]``  — all resources × buckets × events,
* ``stamps:   int32[R, B]``     — the *window index* (``t // win``) written last,
* ``rt_sum:   float32[R, B]``   — response-time sum,
* ``min_rt:   int32[R, B]``     — per-bucket min RT (scatter-min).

Bucket b of row r is live at window index ``now_idx`` iff
``0 <= now_idx - stamp < B``, the subtraction done in int32 two's
complement (PyTorch int32 arithmetic wraps on both CPU and CUDA, as XLA's
does). Window indices are computed on the HOST from exact Python ints
(:meth:`WindowSpec.index_of`) and reach these functions as Python ints in
int32 range; host-side arithmetic on them wraps through :func:`wrap_i32`
and takes the bucket with Python's floor ``%``, which is what
``jnp``'s ``%`` gives for a positive divisor.

Every function updates ``state`` IN PLACE and returns it: the port's
counterpart of the JAX package's buffer donation (one copy of each table,
no new table per step). The counter and ``rt_sum`` scatter-adds go
through :func:`ops.scatter_add.scatter_add`, the port of the JAX
package's one TPU kernel; the ``min_rt`` min stays plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from sentinel_tpu_torch.ops import scatter_add as sa
from sentinel_tpu_torch.stats import events as ev

INT32_MAX = 2 ** 31 - 1
# Stamp value meaning "never written" (see the JAX package's NEVER).
NEVER = -(2 ** 30)


def wrap_i32(x: int) -> int:
    """Reduce a Python int into int32 range (two's-complement wrap)."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Static geometry. Reference defaults: the "second" window is
    2 × 500 ms, the "minute" window 60 × 1000 ms."""

    buckets: int
    win_ms: int
    track_rt: bool = True

    @property
    def interval_ms(self) -> int:
        return self.buckets * self.win_ms

    def index_of(self, now_ms: int) -> int:
        """HOST-side: exact window index of absolute time ``now_ms``,
        reduced mod 2^32 into int32 range."""
        return wrap_i32(now_ms // self.win_ms)


MINUTE_SPEC = WindowSpec(buckets=60, win_ms=1000, track_rt=True)


class WindowState(NamedTuple):
    counters: torch.Tensor         # int32[R, B, E]
    stamps: torch.Tensor           # int32[R, B]
    rt_sum: torch.Tensor           # float32[R, B] (or [R, 0] when untracked)
    min_rt: torch.Tensor           # int32[R, B]   (or [R, 0] when untracked)


def init_window(spec: WindowSpec, rows: int, num_events: int = ev.NUM_EVENTS,
                device="cpu") -> WindowState:
    b_rt = spec.buckets if spec.track_rt else 0
    return WindowState(
        counters=torch.zeros((rows, spec.buckets, num_events),
                             dtype=torch.int32, device=device),
        stamps=torch.full((rows, spec.buckets), NEVER, dtype=torch.int32,
                          device=device),
        rt_sum=torch.zeros((rows, b_rt), dtype=torch.float32, device=device),
        min_rt=torch.full((rows, b_rt), INT32_MAX, dtype=torch.int32,
                          device=device),
    )


def _bucket_of(spec: WindowSpec, now_idx: int) -> int:
    return now_idx % spec.buckets


def _drop_rows(rows: torch.Tensor, r: int):
    """``mode="drop"`` index handling → (safe int64 index, in-range mask):
    a negative row wraps once, anything still outside ``[0, r)`` is
    masked (and its index clamped to 0 so no lane indexes out of range)."""
    w = torch.where(rows < 0, rows + r, rows)
    ok = (w >= 0) & (w < r)
    return torch.where(ok, w, 0).long(), ok


def row_mask(rows: torch.Tensor, r: int) -> torch.Tensor:
    """bool[r]: the rows ``rows`` names, with ``mode="drop"`` semantics —
    the dense form of a set-scatter (every duplicate sets the same True,
    so the result does not depend on write order)."""
    idx, ok = _drop_rows(rows, r)
    hit = torch.zeros(r + 1, dtype=torch.bool, device=rows.device)
    hit.index_put_((torch.where(ok, idx, r),), torch.ones_like(ok))
    return hit[:r]


def _gather_rows(rows: torch.Tensor, r: int) -> torch.Tensor:
    """Gather index with the JAX package's semantics: a negative row wraps
    once, anything still out of range clamps into ``[0, r)``."""
    w = torch.where(rows < 0, rows + r, rows)
    return torch.clamp(w, 0, r - 1).long()


def valid_mask(spec: WindowSpec, stamps: torch.Tensor,
               now_idx: int) -> torch.Tensor:
    """Live-bucket mask, same shape as ``stamps`` (wraparound-safe)."""
    delta = now_idx - stamps          # int32 two's-complement difference
    return (delta >= 0) & (delta < spec.buckets)


def window_sum_rows(spec: WindowSpec, state: WindowState, rows: torch.Tensor,
                    event: int, now_idx: int) -> torch.Tensor:
    """Sum of ``event`` over live buckets for each row in ``rows`` →
    int32[N] (int32 sum: wraps like the JAX package's)."""
    r = _gather_rows(rows, state.stamps.shape[0])
    sub = state.counters[r, :, event]                    # [N, B]
    mask = valid_mask(spec, state.stamps[r], now_idx)
    return torch.where(mask, sub, 0).sum(1, dtype=torch.int32)


def window_sum_all(spec: WindowSpec, state: WindowState, event: int,
                   now_idx: int) -> torch.Tensor:
    """Sum of ``event`` over live buckets for every row → int32[R]."""
    mask = valid_mask(spec, state.stamps, now_idx)       # [R, B]
    return torch.where(mask, state.counters[:, :, event], 0).sum(
        1, dtype=torch.int32)


def rolling_totals(spec: WindowSpec, state: WindowState,
                   now_idx: int) -> torch.Tensor:
    """All events, all rows → int32[R, E]."""
    mask = valid_mask(spec, state.stamps, now_idx)       # [R, B]
    return torch.where(mask[:, :, None], state.counters, 0).sum(
        1, dtype=torch.int32)


def rt_totals(spec: WindowSpec, state: WindowState,
              now_idx: int) -> torch.Tensor:
    """RT sum over live buckets for every row → float32[R] (exact while
    each row's sum stays below 2^24; above that the summation order of
    the two packages may differ)."""
    if not spec.track_rt:
        raise ValueError("rt untracked for this window spec")
    mask = valid_mask(spec, state.stamps, now_idx)
    return torch.where(mask, state.rt_sum, 0.0).sum(1)


def prev_window_sum_rows(spec: WindowSpec, state: WindowState,
                         rows: torch.Tensor, event: int,
                         now_idx: int) -> torch.Tensor:
    """Value of ``event`` in the *previous* window (index ``now_idx - 1``)
    per row → int32[N]; zero if that bucket was never written or has been
    recycled since (``StatisticNode.previousPassQps``)."""
    prev = wrap_i32(now_idx - 1)
    k = _bucket_of(spec, prev)
    r = _gather_rows(rows, state.stamps.shape[0])
    vals = state.counters[r, k, event]
    live = state.stamps[r, k] == prev
    return torch.where(live, vals, 0)


def refresh_rows(spec: WindowSpec, state: WindowState, rows: torch.Tensor,
                 now_idx: int) -> WindowState:
    """Lazy-reset the *current* bucket of each touched row
    (``LeapArray.currentWindow`` case 3). ``rows`` >= R are padding.

    Computed densely over the table: the rows touched are marked in a
    [R] mask (duplicates set the same True) and every marked row whose
    stamp differs from ``now_idx`` restarts from zero — exactly the JAX
    package's multiply-by-keep scatter, without a scatter whose duplicate
    writes PyTorch would resolve in arbitrary order."""
    k = _bucket_of(spec, now_idx)
    touched = row_mask(rows, state.stamps.shape[0])
    stamps_k = state.stamps[:, k]
    keep = stamps_k == now_idx
    state.counters[:, k, :].mul_((keep | ~touched).to(torch.int32)[:, None])
    stamps_k.copy_(torch.where(touched, now_idx, stamps_k))
    if spec.track_rt:
        rt_k = state.rt_sum[:, k]
        rt_k.copy_(torch.where(touched, rt_k * keep.to(torch.float32), rt_k))
        mn_k = state.min_rt[:, k]
        mn_k.copy_(torch.where(touched & ~keep, INT32_MAX, mn_k))
    return state


def refresh_all(spec: WindowSpec, state: WindowState,
                now_idx: int) -> WindowState:
    """Lazy-reset the current bucket of EVERY row — the hot-path form of
    :func:`refresh_rows`: one linear sweep of ``counters[:, k, :]``.
    Requires ``buckets >= 2`` (with B == 1 restamping untouched rows
    would erase their previous-window reads; callers use
    :func:`refresh_rows` there)."""
    if spec.buckets < 2:
        raise ValueError("refresh_all needs B >= 2 (see docstring)")
    k = _bucket_of(spec, now_idx)
    stamps_k = state.stamps[:, k]
    keep = stamps_k == now_idx                               # [R]
    state.counters[:, k, :].mul_(keep.to(torch.int32)[:, None])
    stamps_k.fill_(now_idx)
    if spec.track_rt:
        state.rt_sum[:, k].mul_(keep.to(torch.float32))
        mn_k = state.min_rt[:, k]
        mn_k.copy_(torch.where(keep, mn_k, INT32_MAX))
    return state


def _add_rt(spec: WindowSpec, state: WindowState, rows: torch.Tensor, k: int,
            rt_add: torch.Tensor, rt_min: torch.Tensor) -> None:
    """``rt_sum[rows, k] += rt_add``, ``min_rt[rows, k] = min(.., rt_min)``
    with drop-mode padding. ``rt_add`` is int32 (0 where nothing lands):
    the sum goes through the kernel seam on the ``[R, 1]`` column view
    (row stride B; the kernel wraps and drops the raw rows and converts
    each amount to float32, as the JAX package's ``astype`` does); the
    min stays plain PyTorch (ROADMAP B2)."""
    sa.scatter_add(state.rt_sum[:, k:k + 1], rows, None, rt_add[:, None])
    idx, ok = _drop_rows(rows, state.min_rt.shape[0])
    state.min_rt[:, k].scatter_reduce_(
        0, idx, torch.where(ok, rt_min, INT32_MAX), reduce="amin")


def add_rows_vec(spec: WindowSpec, state: WindowState, rows: torch.Tensor,
                 payload: torch.Tensor, now_idx: int,
                 rt_ms: Optional[torch.Tensor] = None,
                 rt_valid: Optional[torch.Tensor] = None) -> WindowState:
    """Scatter-add a full event-lane vector per row: ``payload[N, E]``
    lands in the current bucket of ``rows`` (one kernel launch in payload
    mode). Padding rows >= R drop."""
    k = _bucket_of(spec, now_idx)
    sa.scatter_add(state.counters[:, k, :], rows, None, payload)
    if spec.track_rt and rt_ms is not None:
        amt = rt_ms if rt_valid is None else torch.where(rt_valid, rt_ms, 0)
        mn = (rt_ms if rt_valid is None
              else torch.where(rt_valid, rt_ms, INT32_MAX))
        _add_rt(spec, state, rows, k, amt, mn)
    return state


def add_one_row(spec: WindowSpec, state: WindowState, row: int,
                vec: torch.Tensor, now_idx: int,
                rt_add: Optional[torch.Tensor] = None,
                rt_min: Optional[torch.Tensor] = None) -> WindowState:
    """Add a pre-reduced event vector to ONE row's current bucket (the
    global ENTRY row's contribution as one slice update, not a second
    scatter half). Caller must have refreshed the row at ``now_idx``."""
    k = _bucket_of(spec, now_idx)
    state.counters[row, k, :].add_(vec)
    if spec.track_rt and rt_add is not None:
        state.rt_sum[row, k].add_(rt_add.to(torch.float32))
        if rt_min is not None:
            mn = state.min_rt[row, k]
            mn.copy_(torch.minimum(mn, rt_min))
    return state


def add_rows(spec: WindowSpec, state: WindowState, rows: torch.Tensor,
             event: int, amounts: torch.Tensor, now_idx: int,
             rt_ms: Optional[torch.Tensor] = None) -> WindowState:
    """Scatter-add ``amounts`` of ``event`` into the current bucket of
    ``rows`` (caller refreshed first). Padding rows must be >= R."""
    k = _bucket_of(spec, now_idx)
    sa.scatter_add(state.counters[:, k, :], rows,
                   torch.full_like(rows, event), amounts)
    if spec.track_rt and rt_ms is not None:
        _add_rt(spec, state, rows, k, rt_ms, rt_ms)
    return state


def add_rows_multi(spec: WindowSpec, state: WindowState, rows: torch.Tensor,
                   event_ids: torch.Tensor, amounts: torch.Tensor,
                   now_idx: int) -> WindowState:
    """Scatter-add with per-element event ids (fused multi-event record)."""
    k = _bucket_of(spec, now_idx)
    sa.scatter_add(state.counters[:, k, :], rows, event_ids, amounts)
    return state


def uncount_rows(spec: WindowSpec, state: WindowState, rows: torch.Tensor,
                 idxs: torch.Tensor, event: int,
                 amounts: torch.Tensor) -> WindowState:
    """Subtract ``amounts`` of ``event`` from the bucket at window index
    ``idxs`` of each row, only where that bucket still holds the stamp
    ``idxs`` (a rotated bucket already reads zero). Reverses a
    reservation recorded earlier in the same ring lap: the unused tokens
    of an expired host lease. Padding rows >= R drop.

    One kernel launch: the per-lane bucket indexes the ``[R·B, E]`` view
    of the counters (key ``row·B + k``), so a padding row lands past the
    table's end and a negative row wraps once, as the reference's
    ``.at[rows, k, event]`` does."""
    r_dim, b_dim, e_dim = state.counters.shape
    k = torch.remainder(idxs, b_dim)
    live = state.stamps[torch.clamp(rows, 0, r_dim - 1).long(),
                        k.long()] == idxs
    amt = torch.where(live, amounts, 0)
    sa.scatter_add(state.counters.view(r_dim * b_dim, e_dim),
                   rows * b_dim + k, torch.full_like(rows, event), -amt)
    return state


def settle_occupied(spec: WindowSpec, state: WindowState,
                    occ_cnt: torch.Tensor, occ_win: torch.Tensor,
                    now_idx: int, event: int):
    """Materialize occupy bookings into the window so the booking ring can
    be reset (a rule reload rebuilds the flow state) without forgetting
    admissions already granted → ``(state, pend_cnt, pend_win)``.

    A LANDED booking (``0 <= now - w < B``, count > 0) is credited as
    ``event`` counts into its target bucket ``w % B``, which is first
    reset (every lane and the rt columns) and restamped to ``w`` where it
    is dead or rotated. A PENDING booking (``now - w == -1``) is returned
    in ``pend_cnt``/``pend_win`` (zero / NEVER elsewhere) for the fresh
    ring; anything older is dropped. Dense over the table, one pass per
    ring slot; ``state`` is updated in place. Runs at a rule reload only,
    and reads nothing back."""
    r_dim = state.stamps.shape[0]
    b_dim = spec.buckets
    rr = torch.arange(r_dim, device=occ_cnt.device)
    bsel_cols = torch.arange(b_dim, device=occ_cnt.device)[None, :]
    counters, stamps = state.counters, state.stamps
    pend_cnt = torch.zeros_like(occ_cnt)
    pend_win = torch.full_like(occ_win, NEVER)
    for s in range(occ_cnt.shape[1]):
        w = occ_win[:, s]
        c = occ_cnt[:, s]
        age = now_idx - w
        landed = (age >= 0) & (age < b_dim) & (c > 0)
        pending = (age == -1) & (c > 0)
        k = torch.where(landed, torch.remainder(w, b_dim), 0)
        live = stamps[rr, k.long()] == w
        bsel = bsel_cols == k[:, None]                        # [R, B]
        reset_rb = (landed & ~live)[:, None] & bsel
        counters.masked_fill_(reset_rb[:, :, None], 0)
        if spec.track_rt:
            state.rt_sum.masked_fill_(reset_rb, 0.0)
            state.min_rt.masked_fill_(reset_rb, INT32_MAX)
        hit = landed[:, None] & bsel
        stamps.copy_(torch.where(hit, w[:, None], stamps))
        counters[:, :, event].add_(
            torch.where(hit, c.to(torch.int32)[:, None], 0))
        pend_cnt[:, s] = torch.where(pending, c, 0.0)
        pend_win[:, s] = torch.where(pending, w, NEVER)
    return state, pend_cnt, pend_win


def invalidate_rows(spec: WindowSpec, state: WindowState,
                    rows: torch.Tensor) -> WindowState:
    """Forget all history of ``rows`` (registry eviction → row reuse):
    stamps go to NEVER so every bucket reads as deprecated. Padding rows
    >= R drop."""
    hit = row_mask(rows, state.stamps.shape[0])
    state.stamps.masked_fill_(hit[:, None], NEVER)
    return state


def min_rt_rows(spec: WindowSpec, state: WindowState, rows: torch.Tensor,
                now_idx: int, default_rt: int) -> torch.Tensor:
    """Min RT over live buckets per row (``ArrayMetric.minRt`` — returns
    ``statisticMaxRt`` when nothing recorded)."""
    if not spec.track_rt:
        raise ValueError("rt untracked for this window spec")
    r = _gather_rows(rows, state.stamps.shape[0])
    mask = valid_mask(spec, state.stamps[r], now_idx)
    vals = torch.where(mask, state.min_rt[r], INT32_MAX)
    m = vals.min(dim=1).values
    return torch.where(m == INT32_MAX, default_rt, m).to(torch.int32)
