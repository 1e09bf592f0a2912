"""Row-shard math of the sharded cluster token engine.

The PyTorch port's own copy of ``sentinel_tpu/parallel/shard_math.py``
(the same functions, so both packages route a request stream alike):

* **ownership** — a global row lives on shard ``row // rows_per_shard``
  at local position ``row % rows_per_shard`` (contiguous slabs: shard
  ``s`` owns the rows ``[s·L, (s+1)·L)`` of a ``[S·L, ...]`` tensor);
* **geometry validation** — row dimensions must divide over the shards,
  with an actionable error;
* **request routing** — grouping a flat request stream into the dense
  ``[S, Bl]`` per-shard lane layout the sharded step consumes, and
  scattering the ``[S, Bl]`` verdicts back into request order.

The routing plan is a pure function of the request ids and the geometry.
:func:`mask_to_local_lanes` keeps only the lanes of the shards one
process owns (multi-process ingestion, ROADMAP A11).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from sentinel_tpu_torch.core.batching import pad_pow2


def owner_shard(global_rows, rows_per_shard: int):
    """Shard index owning each global row (contiguous-slab layout)."""
    return global_rows // rows_per_shard


def local_row(global_rows, rows_per_shard: int):
    """Row position within the owner shard's local slab."""
    return global_rows % rows_per_shard


def validate_divisible(name: str, dim: int, n_shards: int,
                       hint: str = "") -> None:
    """Fail fast (with a fix) when a row dimension can't shard evenly."""
    if dim % n_shards:
        raise ValueError(
            f"{name}={dim} does not divide over {n_shards} shards; "
            + (hint or f"round {name} up to a multiple of {n_shards}"))


class RoutedLanes(NamedTuple):
    """Dense per-shard lane arrays, shape ``[S, Bl]`` (``Bl`` = power of
    two ≥ the busiest shard's request count). Flattened on axis 0 they
    feed a ``TokenBatch`` directly (shard ``s`` owns lanes
    ``[s·Bl, (s+1)·Bl)``)."""

    rows: np.ndarray         # int32[S, Bl] — local row within owner shard
    acquire: np.ndarray      # int32[S, Bl]
    prioritized: np.ndarray  # bool[S, Bl]
    valid: np.ndarray        # bool[S, Bl]
    lanes: int               # Bl


class RoutingPlan(NamedTuple):
    """Everything needed to scatter ``[S, Bl]`` verdicts back into the
    original request order. ``status0`` carries the host-predecided
    status per request (bad-request / no-rule); routed requests keep the
    fail placeholder and are overwritten by the device verdict."""

    src: np.ndarray          # int64[m] — original index of routed request
    shard: np.ndarray        # int64[m] — owner shard (sorted, stable)
    lane: np.ndarray         # int64[m] — lane within the shard
    status0: np.ndarray      # int64[n] — predecided status per request


def route_requests(
        rowg: np.ndarray, acquire: np.ndarray, prioritized: np.ndarray,
        n_shards: int, rows_per_shard: int, *,
        status_fail: int, status_bad: int, status_no_rule: int,
) -> Tuple[Optional[RoutedLanes], RoutingPlan]:
    """Group a flat request stream into per-shard lanes (vectorized).

    ``rowg`` holds each request's GLOBAL row, ``< 0`` for unroutable ids.
    Returns ``(lanes, plan)``; ``lanes is None`` when nothing is
    routable (``plan.status0`` is then final). One argsort + one scatter
    — no per-request Python loop.
    """
    n = rowg.shape[0]
    acq_arr = np.asarray(acquire, np.int64)
    prio_arr = (np.asarray(prioritized, np.bool_) if prioritized is not None
                else np.zeros(n, np.bool_))
    bad = acq_arr <= 0
    norule = (rowg < 0) & ~bad
    status0 = np.where(
        bad, status_bad,
        np.where(norule, status_no_rule, status_fail)).astype(np.int64)
    ok = ~bad & ~norule
    if not ok.any():
        return None, RoutingPlan(
            src=np.zeros(0, np.int64), shard=np.zeros(0, np.int64),
            lane=np.zeros(0, np.int64), status0=status0)
    idx_ok = np.nonzero(ok)[0]
    sh = rowg[idx_ok] // rows_per_shard
    order = np.argsort(sh, kind="stable")
    sh_s = sh[order]
    counts = np.bincount(sh_s, minlength=n_shards)
    blp = pad_pow2(int(counts.max()))
    starts = np.zeros(n_shards, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(sh_s.shape[0], dtype=np.int64) - np.repeat(starts, counts)
    src = idx_ok[order]
    rows = np.zeros((n_shards, blp), np.int32)
    acq2 = np.zeros((n_shards, blp), np.int32)
    prio2 = np.zeros((n_shards, blp), np.bool_)
    valid2 = np.zeros((n_shards, blp), np.bool_)
    rows[sh_s, pos] = (rowg[src] % rows_per_shard).astype(np.int32)
    acq2[sh_s, pos] = acq_arr[src].astype(np.int32)
    prio2[sh_s, pos] = prio_arr[src]
    valid2[sh_s, pos] = True
    return (RoutedLanes(rows=rows, acquire=acq2, prioritized=prio2,
                        valid=valid2, lanes=blp),
            RoutingPlan(src=src, shard=sh_s, lane=pos, status0=status0))


def scatter_verdicts(plan: RoutingPlan, lanes: int,
                     status: np.ndarray, wait_ms: np.ndarray,
                     remaining: np.ndarray,
                     n_shards: int) -> List[Tuple[int, int, int]]:
    """Inverse of :func:`route_requests`: fold ``[S·Bl]`` verdict arrays
    back into request order → aligned ``(status, wait_ms, remaining)``."""
    st = np.asarray(status).reshape(n_shards, lanes)
    wt = np.asarray(wait_ms).reshape(n_shards, lanes)
    rm = np.asarray(remaining).reshape(n_shards, lanes)
    n = plan.status0.shape[0]
    st_o = plan.status0.copy()
    wt_o = np.zeros(n, np.int64)
    rm_o = np.zeros(n, np.int64)
    st_o[plan.src] = st[plan.shard, plan.lane]
    wt_o[plan.src] = wt[plan.shard, plan.lane]
    rm_o[plan.src] = rm[plan.shard, plan.lane]
    return list(zip(st_o.tolist(), wt_o.tolist(), rm_o.tolist()))


def mask_to_local_lanes(lanes: RoutedLanes, plan: RoutingPlan,
                        local_shards: Sequence[int]) -> RoutedLanes:
    """Host-local ingestion: zero every lane NOT owned by this process.

    With shards spread over several processes each process materializes
    only the shards it owns, so the other lanes of its host arrays are
    never read — zeroing them documents (and enforces) that only the
    local slice of the payload has to exist on this host."""
    keep = np.zeros(lanes.rows.shape[0], np.bool_)
    keep[np.asarray(list(local_shards), np.int64)] = True
    k = keep[:, None]
    return RoutedLanes(
        rows=np.where(k, lanes.rows, 0),
        acquire=np.where(k, lanes.acquire, 0),
        prioritized=np.where(k, lanes.prioritized, False),
        valid=np.where(k, lanes.valid, False),
        lanes=lanes.lanes)
