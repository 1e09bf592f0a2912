"""Cluster-wide aggregation of per-process telemetry counters.

Port of ``sentinel_tpu/multihost/obs_agg.py``. Each process owns its own
``Sentinel.obs`` (obs/ — per-process
:class:`~sentinel_tpu_torch.obs.counters.CounterSet`, spans,
histograms); only the COUNTERS have a fleet-meaningful sum, and summing
them is a pure reduction over a fixed-order integer vector
(:func:`~sentinel_tpu_torch.obs.counters.catalog_vector`: the
append-only ``CATALOG`` wire format, so processes on different code
revisions still line up on the shared prefix). The collective is one
``all_gather`` of that ``int64[len(CATALOG)]`` vector — every process
learns every other process's counts, the coordinator (or anyone) renders
totals. With one process (tests, reference jobs) the gather degenerates
to an identity reshape, so the same code path runs 1-process and
N-process unchanged.

:func:`aggregate_topk` does the same for the hot-resource telemetry
layer (obs/telemetry.py): each process's top-K rides one fixed-shape
gather (utf-8 names padded to :data:`TOPK_NAME_BYTES` + int64
load/pass/block) and merges by resource name into a cluster-wide hot
view.

:func:`aggregate_resource_hist` extends that merge to the per-resource
RT histogram table (obs/resource_hist.py): cumulative log-bucket count
vectors are pure sums, so summing each resource's vector across
processes and re-extracting quantiles host-side yields the FLEET-WIDE
tail — the true cluster p99, not a mean of per-process p99s.

These are COLLECTIVES: every process must call them the same number of
times, in the same order relative to other collectives (the multihost
SPMD rule — see multihost/ingest.py). Never call them from only the
coordinator. The wire shapes and the merge order are the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.multihost import bootstrap
from sentinel_tpu_torch.obs import counters as obs_counters


def _gather(arr: np.ndarray) -> Tuple[np.ndarray, int]:
    """``[P, *arr.shape]`` of every process's ``arr`` (process order) and
    this process's index; one process (no runtime) → ``arr[None]``."""
    rt = bootstrap.active_runtime()
    if rt is None:
        return arr[None], 0
    g = rt.all_gather(torch.from_numpy(np.ascontiguousarray(arr)))
    return g.cpu().numpy(), rt.process_index


def _process_index() -> int:
    rt = bootstrap.active_runtime()
    return 0 if rt is None else rt.process_index


def _process_count() -> int:
    rt = bootstrap.active_runtime()
    return 1 if rt is None else rt.process_count


def local_counter_vector(sentinel) -> np.ndarray:
    """This process's counters in the fixed ``CATALOG`` order
    (``int64[len(CATALOG)]``)."""
    obs = getattr(sentinel, "obs", None)
    counts = {} if obs is None else obs.counters.snapshot()
    return obs_counters.catalog_vector(counts)


def aggregate_counters(sentinel) -> Dict[str, object]:
    """Gather + sum every process's counter vector (collective — call on
    ALL processes).

    Returns ``{"process_count", "process_index", "per_process":
    [counts...], "total": counts}`` where each ``counts`` is a
    ``{catalog key: int}`` dict (zero entries elided, matching
    ``CounterSet.snapshot``).
    """
    local = local_counter_vector(sentinel)
    gathered, pid = _gather(local)
    gathered = gathered.reshape(-1, local.shape[0])
    per_process: List[Dict[str, int]] = [
        obs_counters.vector_counts(row) for row in gathered]
    total = obs_counters.vector_counts(gathered.sum(axis=0))
    return {
        "process_count": int(gathered.shape[0]),
        "process_index": int(pid),
        "per_process": per_process,
        "total": total,
    }


#: Fixed per-entry name payload of the top-K gather (utf-8, truncated —
#: wire format like CATALOG: changing it breaks cross-revision merges).
TOPK_NAME_BYTES = 64


def _topk_payload(sentinel, k: int):
    """This process's hot set as fixed-shape gather payload:
    ``(uint8[k, TOPK_NAME_BYTES] names, int64[k, 3] load/pass/block)``,
    empty slots marked by load == -1."""
    names = np.zeros((k, TOPK_NAME_BYTES), np.uint8)
    stats = np.full((k, 3), -1, np.int64)
    telemetry = getattr(sentinel, "telemetry", None)
    entries = telemetry.hot_entries(k) if telemetry is not None else []
    for i, h in enumerate(entries[:k]):
        raw = h["resource"].encode("utf-8")[:TOPK_NAME_BYTES]
        names[i, :len(raw)] = np.frombuffer(raw, np.uint8)
        stats[i] = (h["load"], h["pass"], h["block"])
    return names, stats


def aggregate_topk(sentinel, k: Optional[int] = None) -> Dict[str, object]:
    """Gather-merge every process's hot-resource top-K into ONE
    cluster-wide hot view (collective — call on ALL processes, with the
    same ``k``; defaults to this engine's ``telemetry.k``, which matches
    fleet-wide when the knob env is uniform).

    Per-process engines are independent (each serves its own traffic),
    so the cluster view sums load/pass/block per resource NAME across
    processes and re-ranks — a resource hot on several outranks one
    spiking on a single process. Returns ``{"process_count",
    "process_index", "k", "hot": [{resource, load, pass, block, hosts},
    ...]}`` (top-k, identical on every process)."""
    telemetry = getattr(sentinel, "telemetry", None)
    if k is None:
        k = telemetry.k if telemetry is not None else 16
    k = max(1, int(k))
    names, stats = _topk_payload(sentinel, k)
    g_names, pid = _gather(names)
    g_stats, _ = _gather(stats)
    g_names = g_names.reshape(-1, k, TOPK_NAME_BYTES)
    g_stats = g_stats.reshape(-1, k, 3)
    merged: Dict[str, List[int]] = {}
    hosts: Dict[str, int] = {}
    for p in range(g_stats.shape[0]):
        for i in range(k):
            load = int(g_stats[p, i, 0])
            if load < 0:
                continue
            raw = bytes(g_names[p, i]).rstrip(b"\x00")
            name = raw.decode("utf-8", errors="replace")
            cur = merged.setdefault(name, [0, 0, 0])
            cur[0] += load
            cur[1] += int(g_stats[p, i, 1])
            cur[2] += int(g_stats[p, i, 2])
            hosts[name] = hosts.get(name, 0) + 1
    ranked = sorted(merged.items(), key=lambda it: (-it[1][0], it[0]))[:k]
    return {
        "process_count": int(g_stats.shape[0]),
        "process_index": int(pid),
        "k": k,
        "hot": [{"resource": name, "load": s[0], "pass": s[1],
                 "block": s[2], "hosts": hosts[name]}
                for name, s in ranked],
    }


def _resource_hist_payload(sentinel, k: int, hb: int):
    """This process's hot set + histogram rows as fixed-shape gather
    payload: ``(uint8[k, TOPK_NAME_BYTES] names, int64[k, hb] counts)``,
    empty slots marked by ``counts[i, 0] == -1`` (real bucket counts are
    never negative)."""
    names = np.zeros((k, TOPK_NAME_BYTES), np.uint8)
    hists = np.full((k, hb), -1, np.int64)
    telemetry = getattr(sentinel, "telemetry", None)
    entries = telemetry.hot_entries(k) if telemetry is not None else []
    for i, h in enumerate(entries[:k]):
        vec = h.get("rt_hist")
        if vec is None or len(vec) != hb:
            continue
        raw = h["resource"].encode("utf-8")[:TOPK_NAME_BYTES]
        names[i, :len(raw)] = np.frombuffer(raw, np.uint8)
        hists[i] = np.asarray(vec, np.int64)
    return names, hists


def aggregate_resource_hist(sentinel,
                            k: Optional[int] = None) -> Dict[str, object]:
    """Gather-merge every process's per-resource RT histogram rows into
    ONE fleet-wide tail view (collective — call on ALL processes, with
    the same ``k``; the bucket count comes from this engine's spec and
    must be fleet-uniform, which SENTINEL_RESOURCE_HIST_BUCKETS being a
    uniform env guarantees).

    Cumulative bucket counts sum exactly across processes, so the
    quantiles extracted from the summed vectors are the TRUE fleet
    quantiles. Returns ``{"process_count", "process_index", "k",
    "hist_buckets", "hot": [{resource, total, hosts, rt_hist, rt_p50_ms,
    rt_p95_ms, rt_p99_ms}, ...]}`` ranked by total count (identical on
    every process). Empty when the histogram table is disabled
    (``hist_buckets == 0``)."""
    from sentinel_tpu_torch.obs import resource_hist

    telemetry = getattr(sentinel, "telemetry", None)
    if k is None:
        k = telemetry.k if telemetry is not None else 16
    k = max(1, int(k))
    spec = getattr(sentinel, "spec", None)
    hb = int(getattr(spec, "hist_buckets", 0) or 0)
    if hb <= 0:
        return {"process_count": _process_count(),
                "process_index": _process_index(),
                "k": k, "hist_buckets": 0, "hot": []}
    names, hists = _resource_hist_payload(sentinel, k, hb)
    g_names, pid = _gather(names)
    g_hists, _ = _gather(hists)
    g_names = g_names.reshape(-1, k, TOPK_NAME_BYTES)
    g_hists = g_hists.reshape(-1, k, hb)
    merged: Dict[str, np.ndarray] = {}
    hosts: Dict[str, int] = {}
    for p in range(g_hists.shape[0]):
        for i in range(k):
            if g_hists[p, i, 0] < 0:
                continue
            raw = bytes(g_names[p, i]).rstrip(b"\x00")
            name = raw.decode("utf-8", errors="replace")
            if name in merged:
                merged[name] = merged[name] + g_hists[p, i]
            else:
                merged[name] = g_hists[p, i].copy()
            hosts[name] = hosts.get(name, 0) + 1
    ranked = sorted(merged.items(),
                    key=lambda it: (-int(it[1].sum()), it[0]))[:k]
    hot = []
    for name, vec in ranked:
        qs = resource_hist.np_quantiles(vec.astype(np.int64))
        hot.append({
            "resource": name,
            "total": int(vec.sum()),
            "hosts": hosts[name],
            "rt_hist": [int(c) for c in vec],
            "rt_p50_ms": round(float(qs[0]), 3),
            "rt_p95_ms": round(float(qs[1]), 3),
            "rt_p99_ms": round(float(qs[2]), 3),
        })
    return {
        "process_count": int(g_hists.shape[0]),
        "process_index": int(pid),
        "k": k,
        "hist_buckets": hb,
        "hot": hot,
    }


def coordinator_report(sentinel, runtime=None) -> Optional[Dict[str, object]]:
    """:func:`aggregate_counters` (still collective — every process calls
    this), but only the coordinator gets the report back; workers get
    ``None``. ``runtime`` is an optional
    :class:`~sentinel_tpu_torch.multihost.bootstrap.MultihostRuntime` —
    without it, coordinator-ness falls back to process index 0."""
    agg = aggregate_counters(sentinel)
    if runtime is not None:
        is_coord = runtime.is_coordinator
    else:
        is_coord = agg["process_index"] == 0
    return agg if is_coord else None
