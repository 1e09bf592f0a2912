"""Sharded cluster token engine: the ClusterFlowChecker on the GPU.

Port of ``sentinel_tpu/parallel/cluster.py``. Reference semantics
(``sentinel-cluster-server-default``):

* ``ClusterFlowChecker.acquireClusterToken`` (``flow/ClusterFlowChecker.java:55-112``):
  threshold = ``calcGlobalThreshold(rule) × exceedCount`` where the global
  threshold is ``count`` (GLOBAL) or ``count × connectedCount`` (AVG_LOCAL);
  pass ⇒ add PASS/PASS_REQUEST (+OCCUPIED_PASS when prioritized); prioritized
  deficit ⇒ ``tryOccupyNext`` → SHOULD_WAIT(waitInMs) bounded by
  ``maxOccupyRatio``; else BLOCK/BLOCK_REQUEST.
* ``GlobalRequestLimiter``: per-namespace inbound token-request QPS
  self-protection (default 30,000/s, ``ServerFlowConfig.java:26-31``) →
  TOO_MANY_REQUEST.
* ``ClusterMetric``: 10×100 ms LeapArray of ClusterFlowEvent counters —
  here the port's :mod:`sentinel_tpu_torch.stats.window` tensors.

The JAX package shards the state over an ``n_shards``-device mesh and runs
one body per shard under ``shard_map``; the namespace totals are one
``psum``. The port keeps the same S logical shards on ONE device and runs
:func:`cluster_step` once over all of them: flow counters are one window
of ``S·L`` rows (shard ``s`` owns ``[s·L, (s+1)·L)``), the namespace
window ``S·NS`` rows, the hot-key window ``S·PK``; a batch is ``[S·Bl]``
lanes (shard ``s`` owns ``[s·Bl, (s+1)·Bl)``, in ``route_requests``
order). Verdicts and state equal the JAX engine's on an S-device mesh
bit for bit:

* every per-shard segment (the namespace limiter's, the hot-key
  admission's) is keyed by its shard too, so no segment crosses shards —
  each shard's limiter starts from the SUMMED namespace base and ignores
  the other shards' admissions within the batch, as the reference's
  per-shard body does;
* the per-shard pads (``L``, ``NS``, ``PK``: one past the shard's local
  rows, dropped by that shard's scatter) become ONE global pad past the
  whole table (never ``-1``: the scatter-add wraps a negative row once);
* ``psum`` is a float32 sum over the shard axis of the ``[S, NS]``
  namespace totals: the counts are integers below 2^24, so the order of
  the additions does not matter.

Every step records through the ported scatter-add (one payload launch
per window: flows, namespaces and, with hot keys, params). The step runs
eagerly on the engine's device without waiting on it; the state is
updated in place under the engine lock (the reference donates it).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core.batching import pad_pow2
from sentinel_tpu_torch.core.pending import (
    PendingResult, start_host_copy, wait_host_copy,
)
from sentinel_tpu_torch.ops import segments as seg
from sentinel_tpu_torch.parallel import shard_math
from sentinel_tpu_torch.rules.flow import _f32_to_i32
from sentinel_tpu_torch.runtime import resolve_device
from sentinel_tpu_torch.stats import events as ev
from sentinel_tpu_torch.stats.window import (
    WindowSpec, WindowState, add_rows_vec, init_window, invalidate_rows,
    refresh_rows, valid_mask, window_sum_all,
)

# TokenResultStatus parity (CORE/cluster/TokenResultStatus.java)
STATUS_BAD_REQUEST = -4
STATUS_TOO_MANY_REQUEST = -2
STATUS_FAIL = -1
STATUS_OK = 0
STATUS_BLOCKED = 1
STATUS_SHOULD_WAIT = 2
STATUS_NO_RULE_EXISTS = 3
STATUS_NO_REF_RULE_EXISTS = 4
STATUS_NOT_AVAILABLE = 5
STATUS_RELEASE_OK = 6
STATUS_ALREADY_RELEASE = 7

# thresholdType (ClusterRuleConstant)
THRESHOLD_AVG_LOCAL = 0
THRESHOLD_GLOBAL = 1

# ClusterMetric geometry: sampleCount 10 × interval 1000 ms
CLUSTER_WINDOW = WindowSpec(buckets=10, win_ms=100, track_rt=False)

#: "no admissible wait" in the occupy expiry scan (int32 arithmetic)
_NO_WAIT = 2 ** 30


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Static sharded-engine geometry."""

    n_shards: int
    flows_per_shard: int          # L — flow rows owned per shard
    namespaces: int               # NS — namespace slots
    window: WindowSpec = CLUSTER_WINDOW
    param_keys_per_shard: int = 0  # PK — hot-key rows per shard (0 = off)
    max_params: int = 4            # PV — values per param request

    @property
    def total_rows(self) -> int:
        return self.n_shards * self.flows_per_shard

    @property
    def total_param_rows(self) -> int:
        return self.n_shards * max(1, self.param_keys_per_shard)


class ClusterRuleTable(NamedTuple):
    """Device rule arrays, one row per flow row ([S·L])."""

    active: torch.Tensor       # bool[S·L]
    count: torch.Tensor        # float32 — rule threshold
    is_global: torch.Tensor    # bool — GLOBAL vs AVG_LOCAL
    exceed: torch.Tensor       # float32 — exceedCount factor
    max_occupy: torch.Tensor   # float32 — maxOccupyRatio
    ns_id: torch.Tensor        # int32 — owning namespace


class ClusterState(NamedTuple):
    flows: WindowState             # rows = S·L
    ns: WindowState                # rows = S·NS (NS rows a shard)
    params: WindowState            # rows = S·max(1, PK) — hot-key counters


class TokenBatch(NamedTuple):
    """Routed request batch, arrays [S·Bl] (shard s: lanes [s·Bl, (s+1)·Bl))."""

    local_rows: torch.Tensor   # int32 — row within the owner shard [0, L)
    acquire: torch.Tensor      # int32
    prioritized: torch.Tensor  # bool
    valid: torch.Tensor        # bool
    is_param: torch.Tensor     # bool — PARAM_FLOW request (param path)
    param_rows: torch.Tensor   # int32[S·Bl, PV] — local key row; PK = none
    param_count: torch.Tensor  # float32[S·Bl, PV] — raw per-value threshold


class TokenVerdicts(NamedTuple):
    status: torch.Tensor       # int32[S·Bl] — TokenResultStatus codes
    wait_ms: torch.Tensor      # int32[S·Bl]
    remaining: torch.Tensor    # int32[S·Bl]


def init_cluster_state(spec: ClusterSpec, device="cpu") -> ClusterState:
    return ClusterState(
        flows=init_window(spec.window, spec.total_rows, device=device),
        ns=init_window(spec.window, spec.n_shards * spec.namespaces,
                       device=device),
        params=init_window(spec.window, spec.total_param_rows,
                           device=device),
    )


def _admit_segments(keys: torch.Tensor, base: torch.Tensor,
                    amounts: torch.Tensor, limit: torch.Tensor):
    """Sequential greedy admission of ``amounts`` within the segments of
    equal ``keys`` (batch order inside a segment: a stable sort), each
    element against ``base[i]`` and ``limit[i]`` given in batch order →
    ``(admitted bool, remaining float32)`` in batch order, where
    remaining = limit − base − (admitted amount ahead) − own amount.

    The per-segment prefix sums are one global float32 cumsum less the
    segment's base: exact while the batch's total amount stays below
    2^24 (the reference's per-shard cumsum is exact under the same
    bound; ROADMAP C10)."""
    order = seg.sort_by_keys(keys)
    keys_s = keys[order]
    starts = seg.segment_starts(keys_s, torch.zeros_like(keys_s))
    leader = seg.segment_leader_index(starts)
    amt_s, base_s, lim_s = amounts[order], base[order], limit[order]
    admit_s = seg.greedy_admit(base_s, amt_s, lim_s, starts, leader)
    excl_s, _ = seg.segment_prefix_sum(torch.where(admit_s, amt_s, 0.0),
                                       starts, leader)
    rem_s = lim_s - base_s - excl_s - amt_s
    return seg.unsort(order, admit_s), seg.unsort(order, rem_s)


def cluster_step(spec: ClusterSpec, table: ClusterRuleTable,
                 state: ClusterState, batch: TokenBatch,
                 connected: torch.Tensor, ns_limit: torch.Tensor,
                 now_idx: int, in_win_ms: int
                 ) -> Tuple[ClusterState, TokenVerdicts]:
    """One token step over all S shards (the reference's ``_shard_step``
    under ``shard_map``) → (state, verdicts). ``connected`` and
    ``ns_limit`` are float32[NS]; ``now_idx`` and ``in_win_ms`` host ints.
    ``state`` is updated in place."""
    w = spec.window
    dev = batch.local_rows.device
    S, L, NS = spec.n_shards, spec.flows_per_shard, spec.namespaces
    N = batch.local_rows.shape[0]
    Bl = N // S
    shard = torch.arange(N, device=dev) // Bl                 # int64[N]
    f32 = torch.float32
    inf = float("inf")

    rows_local = torch.where(batch.valid, batch.local_rows, 0).long()
    grow = shard * L + rows_local                              # global row
    act_row = table.active[grow]
    active = act_row & batch.valid
    ns_req = torch.where(active, table.ns_id[grow], NS).long()   # NS: none

    # ---- GlobalRequestLimiter: namespace request QPS over all shards ----
    # (the psum: a sum over the shard axis of integer counts < 2^24)
    ns_local = window_sum_all(w, state.ns, ev.PASS, now_idx).to(f32)
    ns_global = ns_local.view(S, NS).sum(0)
    ns_base = torch.cat([ns_global, ns_global.new_zeros(1)])
    ns_lim = torch.cat([ns_limit, ns_limit.new_full((1,), inf)])
    limiter_ok, _ = _admit_segments(
        shard * (NS + 1) + ns_req, ns_base[ns_req],
        torch.where(active, 1.0, 0.0), ns_lim[ns_req])
    proceed = active & limiter_ok

    # ---- per-flow admission (ClusterFlowChecker.acquireClusterToken) ----
    flow_req = proceed & ~batch.is_param
    latest = window_sum_all(w, state.flows, ev.PASS, now_idx).to(f32)
    conn = connected[torch.clamp(table.ns_id, max=NS - 1).long()]   # [S·L]
    thr_rule = table.count * torch.where(table.is_global, 1.0, conn) \
        * table.exceed
    # the never-blocking segment of non-flow lanes: one key past every
    # shard's rows (infinite limit, zero amounts — merging it across
    # shards changes nothing)
    total = S * L
    seg_rows = torch.where(flow_req, grow, total)
    safe = torch.clamp(seg_rows, max=total - 1)
    acq_f = batch.acquire.to(f32)
    admit, remaining_f = _admit_segments(
        seg_rows, latest[safe], torch.where(flow_req, acq_f, 0.0),
        torch.where(seg_rows < total, thr_rule[safe], inf))
    admitted = admit & flow_req
    remaining = _f32_to_i32(torch.where(torch.isfinite(remaining_f),
                                        remaining_f, 0.0))

    # ---- occupy: prioritized deficit pre-books future windows ----
    denied = flow_req & ~admitted
    waiting_sum = window_sum_all(w, state.flows, ev.WAITING, now_idx).to(f32)
    thr_req = thr_rule[grow]
    occupy_open = waiting_sum[grow] <= table.max_occupy[grow] * thr_req
    # expiry scan: waiting until bucket k (stamp s_k) rotates out frees its
    # PASS count at wait = (s_k - now_idx + B)·win - in_win_ms
    stamps_req = state.flows.stamps[grow]                       # [N, B]
    pass_req = state.flows.counters[grow, :, ev.PASS]           # [N, B]
    live = valid_mask(w, stamps_req, now_idx)
    delta = torch.where(live, stamps_req - now_idx, 0)          # [-B+1, 0]
    # freed(k) = sum of pass in buckets expiring no later than bucket k
    freed = torch.where(
        live[:, None, :] & (delta[:, None, :] <= delta[:, :, None]),
        pass_req[:, None, :], 0).sum(2, dtype=torch.int32).to(f32)
    total_pass = latest[grow][:, None]
    fits = (total_pass - freed + acq_f[:, None] <= thr_req[:, None]) & live
    wait_k = (delta + w.buckets) * w.win_ms - in_win_ms         # [N, B]
    wait_k = torch.where(fits & (wait_k > 0), wait_k, _NO_WAIT)
    best_wait = wait_k.min(1).values
    should_wait = (denied & batch.prioritized & occupy_open
                   & (best_wait < _NO_WAIT))
    wait_ms = torch.where(should_wait, best_wait, 0)
    blocked = denied & ~should_wait

    # ---- hot-param admission (ClusterParamFlowChecker.acquireClusterToken) ----
    # a request passes iff EVERY carried value fits, and only then are all
    # its values counted; the host resolves per-item overrides into
    # ``param_count``; values hash onto PK key rows of the owner shard
    PK = spec.param_keys_per_shard
    is_p = proceed & batch.is_param
    if PK:
        prow = batch.param_rows.long()                          # [N, PV]
        PV = prow.shape[1]
        latest_p = window_sum_all(w, state.params, ev.PASS, now_idx).to(f32)
        plive = (prow >= 0) & (prow < PK) & is_p[:, None]
        thr_p = batch.param_count * torch.where(
            table.is_global[grow], 1.0, conn[grow])[:, None]      # [N, PV]
        local_key = torch.where(plive, prow, PK)
        grow_key = shard[:, None] * PK + torch.clamp(local_key, max=PK - 1)
        row_ok, rem_flat = _admit_segments(
            (shard[:, None] * (PK + 1) + local_key).reshape(-1),
            latest_p[grow_key].reshape(-1),
            torch.where(plive, acq_f[:, None], 0.0).reshape(-1),
            torch.where(local_key < PK, thr_p, inf).reshape(-1))
        row_ok = row_ok.view(N, PV)
        rem_flat = torch.where(torch.isfinite(rem_flat), rem_flat,
                               0.0).view(N, PV)
        any_live = plive.any(1)
        all_ok = (row_ok | ~plive).all(1)
        param_pass = is_p & (all_ok | ~any_live)
        param_block = is_p & any_live & ~all_ok
        # remaining is meaningful only for single-value requests (the host
        # packs values from column 0); multi-value → -1 like the reference
        nlive = plive.sum(1, dtype=torch.int32)
        rem_p = _f32_to_i32(torch.where(
            nlive == 1, torch.clamp(rem_flat[:, 0], min=0.0), -1.0))
        hit = plive & param_pass[:, None]
        pad_p = S * PK
        prows = torch.where(hit, shard[:, None] * PK + prow,
                            pad_p).to(torch.int32).reshape(-1)
        refresh_rows(w, state.params, prows, now_idx)
        pay = torch.zeros((N * PV, ev.NUM_EVENTS), dtype=torch.int32,
                          device=dev)
        pay[:, ev.PASS] = torch.where(hit, batch.acquire[:, None],
                                      0).reshape(-1)
        add_rows_vec(w, state.params, prows, pay, now_idx)
    else:
        param_pass = is_p          # param slot disabled: empty values → OK
        param_block = torch.zeros_like(is_p)
        rem_p = torch.full((N,), -1, dtype=torch.int32, device=dev)

    # ---- record (post-decision, like StatisticSlot ordering): one
    # payload launch a window; every event lane lies on a proceeding
    # lane, and int32 adds commute, so the reference's six flow adds and
    # two namespace adds land the same bits ----
    acq = batch.acquire
    frows = torch.where(proceed, grow, total).to(torch.int32)
    refresh_rows(w, state.flows, frows, now_idx)
    pay = torch.zeros((N, ev.NUM_EVENTS), dtype=torch.int32, device=dev)
    pay[:, ev.PASS] = torch.where(admitted, acq, 0)
    pay[:, ev.PASS_REQUEST] = admitted.to(torch.int32)
    pay[:, ev.OCCUPIED_PASS] = torch.where(admitted & batch.prioritized,
                                           acq, 0)
    pay[:, ev.BLOCK] = torch.where(blocked, acq, 0)
    pay[:, ev.BLOCK_REQUEST] = blocked.to(torch.int32)
    pay[:, ev.WAITING] = torch.where(should_wait, acq, 0)
    add_rows_vec(w, state.flows, frows, pay, now_idx)

    nrows = torch.where(active, shard * NS + ns_req,
                        S * NS).to(torch.int32)
    refresh_rows(w, state.ns, nrows, now_idx)
    too_many = active & ~limiter_ok
    npay = torch.zeros((N, ev.NUM_EVENTS), dtype=torch.int32, device=dev)
    npay[:, ev.PASS] = proceed.to(torch.int32)
    npay[:, ev.BLOCK] = too_many.to(torch.int32)
    add_rows_vec(w, state.ns, nrows, npay, now_idx)

    status = torch.full((N,), STATUS_FAIL, dtype=torch.int32, device=dev)
    status = torch.where(batch.valid & ~act_row, STATUS_NO_RULE_EXISTS,
                         status)
    status = torch.where(too_many, STATUS_TOO_MANY_REQUEST, status)
    status = torch.where(blocked, STATUS_BLOCKED, status)
    status = torch.where(should_wait, STATUS_SHOULD_WAIT, status)
    status = torch.where(admitted, STATUS_OK, status)
    status = torch.where(param_block, STATUS_BLOCKED, status)
    status = torch.where(param_pass, STATUS_OK, status)

    remaining = torch.where(admitted, torch.clamp(remaining, min=0), 0)
    remaining = torch.where(param_pass | param_block,
                            torch.where(param_pass, rem_p, 0), remaining)
    return state, TokenVerdicts(status=status,
                                wait_ms=wait_ms.to(torch.int32),
                                remaining=remaining.to(torch.int32))


@dataclasses.dataclass
class ClusterParamFlowRule:
    """Cluster hot-param rule (reference ``ParamFlowRule`` cluster fields:
    flowId, thresholdType, count, plus exclusive per-item thresholds —
    ``parsedHotItems``)."""

    flow_id: int
    count: float
    threshold_type: int = THRESHOLD_AVG_LOCAL
    items: Optional[Dict[object, float]] = None

    def value_threshold(self, value: object) -> float:
        if self.items is not None:
            override = self.items.get(value)
            if override is not None:
                return float(override)
        return float(self.count)


@dataclasses.dataclass
class ClusterFlowRule:
    """Host-facing cluster rule (reference ``FlowRule`` cluster fields +
    ``ClusterFlowConfig``: flowId, thresholdType, count; exceedCount and
    maxOccupyRatio come from ``ClusterServerConfigManager`` server-wide but are
    kept per-rule here, defaulting to the reference's 1.0/1.0)."""

    flow_id: int
    count: float
    threshold_type: int = THRESHOLD_AVG_LOCAL
    exceed_count: float = 1.0
    max_occupy_ratio: float = 1.0


class PendingTokenResults(PendingResult):
    """Handle for an in-flight token batch: the device step is already
    enqueued (and the verdict copy started); :meth:`result` materializes
    the aligned ``(status, wait_ms, remaining)`` list. Lets callers
    double-buffer — dispatch batch N+1 while batch N's verdicts are still
    in flight."""

    __slots__ = ()


class ClusterEngine:
    """Host facade: flow routing, namespace management, the sharded step.

    The reference's ``ClusterFlowRuleManager`` (flowId→rule, namespace→flowIds,
    per-namespace property suppliers) + ``DefaultTokenService`` dispatch,
    collapsed onto dense tensors of S logical shards on one device
    (``device``: ``cuda`` unless the caller asks for another, as the
    runtime resolves it).
    """

    def __init__(self, spec: ClusterSpec, device=None,
                 default_ns_qps: float = 30_000.0):
        self.spec = spec
        self.device = resolve_device(device)

        self._flow_to_row: Dict[int, int] = {}
        self._row_to_flow: Dict[int, int] = {}
        self._ns_ids: Dict[str, int] = {}
        self._flow_ns: Dict[int, str] = {}
        self._rules: Dict[int, ClusterFlowRule] = {}
        self._param_rules: Dict[int, ClusterParamFlowRule] = {}
        self._fid_lookup = None       # dense fid→row (vectorized prep)
        # host-side hot-value sightings per param flow for metricList's
        # topParams (ClusterParamMetric.getTopValues analog): fid →
        # {value: count} over the current window, previous window kept so
        # a read right after rotation isn't empty
        self._param_hits: Dict[int, Dict[object, int]] = {}
        self._param_hits_prev: Dict[int, Dict[object, int]] = {}
        self._param_hits_win = -1
        self._param_hits_cap = 64     # values tracked per flow (LRU-ish)
        self._connected = np.ones(spec.namespaces, np.float32)
        self._default_ns_qps = float(default_ns_qps)
        self._ns_limit = np.full(spec.namespaces, default_ns_qps, np.float32)
        self._next_row_per_shard = [0] * spec.n_shards
        self._free_rows: List[List[int]] = [[] for _ in range(spec.n_shards)]
        self._rr = 0  # round-robin shard cursor for row allocation
        self._lock = threading.RLock()  # guards the in-place state,
        # routing tables, and rule reloads against concurrent server threads

        self.state = init_cluster_state(spec, self.device)
        self._table = self._empty_table()

    # ------------------------------------------------------------------
    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → device tensor (pinned and ``non_blocking`` on
        CUDA: no stream sync)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _empty_table(self) -> ClusterRuleTable:
        n = self.spec.total_rows
        return self._table_from_numpy(
            np.zeros(n, np.bool_), np.zeros(n, np.float32),
            np.zeros(n, np.bool_), np.ones(n, np.float32),
            np.ones(n, np.float32), np.zeros(n, np.int32))

    def _table_from_numpy(self, *cols) -> ClusterRuleTable:
        return ClusterRuleTable(*(self._put(c) for c in cols))

    # ------------------------------------------------------------------
    # Namespace / rule management
    # ------------------------------------------------------------------

    def namespace_id(self, namespace: str) -> int:
        nid = self._ns_ids.get(namespace)
        if nid is None:
            if len(self._ns_ids) >= self.spec.namespaces:
                raise ValueError("namespace capacity exceeded")
            nid = len(self._ns_ids)
            self._ns_ids[namespace] = nid
        return nid

    def set_connected_count(self, namespace: str, count: int) -> None:
        """ConnectionManager.getConnectedCount feed for AVG_LOCAL thresholds."""
        with self._lock:
            self._connected[self.namespace_id(namespace)] = max(1, count)

    def set_namespace_qps_limit(self, namespace: str, limit: float) -> None:
        """ServerFlowConfig.maxAllowedQps per namespace (hot-tunable)."""
        with self._lock:
            self._ns_limit[self.namespace_id(namespace)] = limit

    def namespace_qps_limit(self, namespace: str, *,
                            create: bool = True) -> float:
        """Per-namespace maxAllowedQps. ``create=False`` is a pure read: an
        unregistered namespace returns the default limit without consuming
        one of the ``spec.namespaces`` slots."""
        with self._lock:
            nid = self._ns_ids.get(namespace)
            if nid is None:
                if not create:
                    return float(self._default_ns_qps)
                nid = self.namespace_id(namespace)
            return float(self._ns_limit[nid])

    def namespace_flow_ids(self, namespace: str) -> List[int]:
        """Flow ids registered under a namespace (flow + param rules)."""
        with self._lock:
            return sorted(fid for fid, ns in self._flow_ns.items()
                          if ns == namespace)

    def namespace_rules(self, namespace: str, *, param: bool = False
                        ) -> Dict[int, object]:
        """Read-only snapshot {flow_id: rule} of what this engine ENFORCES
        for a namespace — ``param=False`` → :class:`ClusterFlowRule` entries
        (excluding param-rule proxy rows), ``param=True`` →
        :class:`ClusterParamFlowRule` entries."""
        with self._lock:
            store = self._param_rules if param else self._rules
            return {fid: store[fid]
                    for fid, ns in sorted(self._flow_ns.items())
                    if ns == namespace and fid in store
                    and (param or fid not in self._param_rules)}

    def _forget_rows_locked(self, freed: List[int]) -> None:
        """Invalidate freed rows so a reused row can't inherit the dead
        flow's live counters."""
        if freed:
            invalidate_rows(self.spec.window, self.state.flows,
                            self._put(np.asarray(freed, np.int32)))

    def load_rules(self, namespace: str, rules: Sequence[ClusterFlowRule]) -> None:
        """Replace the namespace's rules (ClusterFlowRuleManager property path).

        Rows of removed flows go to a free list for reuse; their window state
        is invalidated immediately so a reused row can't inherit the dead
        flow's live counters.
        """
        with self._lock:
            self.namespace_id(namespace)
            freed: List[int] = []
            for fid, ns in list(self._flow_ns.items()):
                if (ns == namespace and fid not in {r.flow_id for r in rules}
                        and fid not in self._param_rules):
                    row = self._flow_to_row.pop(fid)
                    self._row_to_flow.pop(row, None)
                    self._flow_ns.pop(fid)
                    self._rules.pop(fid, None)
                    self._free_rows[row // self.spec.flows_per_shard].append(row)
                    freed.append(row)
            for r in rules:
                if r.flow_id not in self._flow_to_row:
                    self._flow_to_row[r.flow_id] = self._alloc_row()
                    self._row_to_flow[self._flow_to_row[r.flow_id]] = r.flow_id
                self._flow_ns[r.flow_id] = namespace
                self._rules[r.flow_id] = r
            self._forget_rows_locked(freed)
            self._rebuild_table()

    def load_param_rules(self, namespace: str,
                         rules: Sequence["ClusterParamFlowRule"]) -> None:
        """Replace the namespace's hot-param rules
        (ClusterParamFlowRuleManager property path). Requires
        ``spec.param_keys_per_shard > 0``."""
        if self.spec.param_keys_per_shard <= 0 and rules:
            raise ValueError("engine built without param key capacity")
        with self._lock:
            self.namespace_id(namespace)
            new_ids = {r.flow_id for r in rules}
            freed: List[int] = []
            for fid, ns in list(self._flow_ns.items()):
                if (ns == namespace and fid in self._param_rules
                        and fid not in new_ids):
                    row = self._flow_to_row.pop(fid)
                    self._row_to_flow.pop(row, None)
                    self._flow_ns.pop(fid)
                    self._rules.pop(fid, None)
                    self._param_rules.pop(fid, None)
                    self._free_rows[row // self.spec.flows_per_shard].append(row)
                    freed.append(row)
            self._forget_rows_locked(freed)
            for r in rules:
                if r.flow_id not in self._flow_to_row:
                    self._flow_to_row[r.flow_id] = self._alloc_row()
                    self._row_to_flow[self._flow_to_row[r.flow_id]] = r.flow_id
                self._flow_ns[r.flow_id] = namespace
                self._param_rules[r.flow_id] = r
                # proxy row in the rule table: ns routing + GLOBAL/AVG flag
                self._rules[r.flow_id] = ClusterFlowRule(
                    flow_id=r.flow_id, count=r.count,
                    threshold_type=r.threshold_type)
            self._rebuild_table()

    def _param_key(self, flow_id: int, value: object) -> int:
        """Stable (process-independent) hash of a param value onto the owner
        shard's PK key rows. Type-tagged so ``1`` and ``"1"`` stay distinct."""
        tag = f"{flow_id}|{type(value).__name__}|{value!r}".encode()
        h = hashlib.blake2s(tag, digest_size=8).digest()
        return int.from_bytes(h, "little") % self.spec.param_keys_per_shard

    def request_param_tokens(self, flow_ids: Sequence[int],
                             acquire: Sequence[int],
                             params: Sequence[Sequence[object]],
                             *, now_ms: int) -> List[Tuple[int, int, int]]:
        """Batched ``TokenService.requestParamToken`` → ``(status, wait_ms,
        remaining)`` per request. Values beyond ``spec.max_params`` per
        request are dropped (cap documented on :class:`ClusterSpec`)."""
        return self.request_param_tokens_nowait(
            flow_ids, acquire, params, now_ms=now_ms).result()

    def request_param_tokens_nowait(
            self, flow_ids: Sequence[int], acquire: Sequence[int],
            params: Sequence[Sequence[object]],
            *, now_ms: int) -> PendingTokenResults:
        """Dispatch-only variant: the step is enqueued and the verdict
        readback deferred to ``.result()`` so callers can overlap batch
        N's readback with batch N+1's host prep + dispatch."""
        n = len(flow_ids)
        S = self.spec.n_shards
        L = self.spec.flows_per_shard
        PV = self.spec.max_params
        PK = self.spec.param_keys_per_shard

        with self._lock:
            per_shard: List[List[int]] = [[] for _ in range(S)]
            results: List[Optional[Tuple[int, int, int]]] = [None] * n
            for i, fid in enumerate(flow_ids):
                rule = self._param_rules.get(int(fid))
                if acquire[i] <= 0:
                    results[i] = (STATUS_BAD_REQUEST, 0, 0)
                elif rule is None:
                    results[i] = (STATUS_NO_RULE_EXISTS, 0, 0)
                elif not params[i]:
                    results[i] = (STATUS_OK, 0, 0)   # empty values pass
                else:
                    per_shard[self._flow_to_row[int(fid)] // L].append(i)

            bl = max((len(p) for p in per_shard), default=0)
            if bl == 0:
                out = [r or (STATUS_FAIL, 0, 0) for r in results]
                return PendingTokenResults(lambda: out)
            blp = pad_pow2(bl)

            rows = np.zeros((S, blp), np.int32)
            acq = np.zeros((S, blp), np.int32)
            valid = np.zeros((S, blp), np.bool_)
            is_param = np.zeros((S, blp), np.bool_)
            prow = np.full((S, blp, PV), PK, np.int32)
            pcnt = np.zeros((S, blp, PV), np.float32)
            win = now_ms // (self.spec.window.win_ms
                             * self.spec.window.buckets)
            if win != self._param_hits_win:
                self._param_hits_prev = self._param_hits
                self._param_hits = {}
                self._param_hits_win = win
            for s in range(S):
                for k, i in enumerate(per_shard[s]):
                    fid = int(flow_ids[i])
                    rule = self._param_rules[fid]
                    rows[s, k] = self._flow_to_row[fid] % L
                    acq[s, k] = acquire[i]
                    valid[s, k] = True
                    is_param[s, k] = True
                    hits = self._param_hits.setdefault(fid, {})
                    for j, v in enumerate(list(params[i])[:PV]):
                        prow[s, k, j] = self._param_key(fid, v)
                        pcnt[s, k, j] = rule.value_threshold(v)
                        if v in hits or len(hits) < self._param_hits_cap:
                            hits[v] = hits.get(v, 0) + int(acquire[i])

            verdicts = self._step_locked(
                rows, acq, np.zeros((S, blp), np.bool_), valid, is_param,
                prow.reshape(S * blp, PV), pcnt.reshape(S * blp, PV),
                now_ms)
        return PendingTokenResults(functools.partial(
            self._gather_results, verdicts, per_shard, results, S, blp))

    def _gather_results(self, verdicts, per_shard, results, S, blp):
        """Deferred readback: materialize the verdict arrays and scatter
        them back into request order (shared by flow + param paths)."""
        st, wt, rm = (a.reshape(S, blp) for a in self._to_host(verdicts))
        for s in range(S):
            for k, i in enumerate(per_shard[s]):
                results[i] = (int(st[s, k]), int(wt[s, k]), int(rm[s, k]))
        return [r or (STATUS_FAIL, 0, 0) for r in results]

    def _alloc_row(self) -> int:
        L = self.spec.flows_per_shard
        for _ in range(self.spec.n_shards):
            s = self._rr
            self._rr = (self._rr + 1) % self.spec.n_shards
            if self._free_rows[s]:
                return self._free_rows[s].pop()
            if self._next_row_per_shard[s] < L:
                local = self._next_row_per_shard[s]
                self._next_row_per_shard[s] += 1
                return s * L + local
        raise ValueError("cluster flow capacity exceeded")

    def _rebuild_fid_lookup(self) -> None:
        """Dense flow-id → global-row array for the vectorized request
        prep; None when ids are sparse enough that the array would waste
        memory (the loop path then resolves through the dict)."""
        self._fid_lookup = None
        if not self._flow_to_row:
            return
        if min(self._flow_to_row) < 0:
            return        # negative fids route via the dict; array can't
        max_fid = max(self._flow_to_row)
        if max_fid < max(1 << 20, 4 * len(self._flow_to_row)):
            lut = np.full(max_fid + 1, -1, np.int64)
            for fid, row in self._flow_to_row.items():
                lut[fid] = row
            self._fid_lookup = lut

    def _rebuild_table(self) -> None:
        self._rebuild_fid_lookup()
        n = self.spec.total_rows
        active = np.zeros(n, np.bool_)
        count = np.zeros(n, np.float32)
        is_global = np.zeros(n, np.bool_)
        exceed = np.ones(n, np.float32)
        max_occ = np.ones(n, np.float32)
        ns_id = np.zeros(n, np.int32)
        for fid, row in self._flow_to_row.items():
            r = self._rules[fid]
            active[row] = True
            count[row] = r.count
            is_global[row] = r.threshold_type == THRESHOLD_GLOBAL
            exceed[row] = r.exceed_count
            max_occ[row] = r.max_occupy_ratio
            ns_id[row] = self._ns_ids[self._flow_ns[fid]]
        self._table = self._table_from_numpy(active, count, is_global,
                                             exceed, max_occ, ns_id)

    # ------------------------------------------------------------------
    # Token requests
    # ------------------------------------------------------------------

    def request_tokens(self, flow_ids: Sequence[int], acquire: Sequence[int],
                       prioritized: Optional[Sequence[bool]] = None,
                       *, now_ms: int) -> List[Tuple[int, int, int]]:
        """Batched ``TokenService.requestToken`` → list of
        ``(status, wait_ms, remaining)`` aligned with the inputs."""
        return self.request_tokens_nowait(
            flow_ids, acquire, prioritized, now_ms=now_ms).result()

    def request_tokens_nowait(self, flow_ids: Sequence[int],
                              acquire: Sequence[int],
                              prioritized: Optional[Sequence[bool]] = None,
                              *, now_ms: int) -> PendingTokenResults:
        """Dispatch-only ``requestToken``: enqueue the step, start the
        device→host verdict copy, and defer materialization to
        ``.result()`` (state updates still apply in dispatch order under
        the engine lock)."""
        n = len(flow_ids)
        S = self.spec.n_shards
        L = self.spec.flows_per_shard

        with self._lock:
            vec = self._vector_prep(flow_ids, acquire, prioritized, n, S, L)
            if vec is not None:
                prep, gather = vec
                if prep is None:        # nothing routable: results are final
                    return PendingTokenResults(lambda: gather)
                rows, acq, prio, valid, blp = prep
            else:
                if prioritized is None:     # numpy arrays: no truthiness
                    prioritized = [False] * n
                per_shard: List[List[int]] = [[] for _ in range(S)]
                results: List[Optional[Tuple[int, int, int]]] = [None] * n
                for i, fid in enumerate(flow_ids):
                    row = self._flow_to_row.get(int(fid))
                    if acquire[i] <= 0:
                        # DefaultTokenService.requestToken count validation
                        results[i] = (STATUS_BAD_REQUEST, 0, 0)
                    elif row is None:
                        results[i] = (STATUS_NO_RULE_EXISTS, 0, 0)
                    else:
                        per_shard[row // L].append(i)

                bl = max((len(p) for p in per_shard), default=0)
                if bl == 0:
                    out = [r or (STATUS_FAIL, 0, 0) for r in results]
                    return PendingTokenResults(lambda: out)
                blp = pad_pow2(bl)

                rows = np.zeros((S, blp), np.int32)
                acq = np.zeros((S, blp), np.int32)
                prio = np.zeros((S, blp), np.bool_)
                valid = np.zeros((S, blp), np.bool_)
                for s in range(S):
                    for k, i in enumerate(per_shard[s]):
                        rows[s, k] = self._flow_to_row[int(flow_ids[i])] % L
                        acq[s, k] = acquire[i]
                        prio[s, k] = bool(prioritized[i])
                        valid[s, k] = True

            verdicts = self.step_routed(rows, acq, prio, valid, blp,
                                        now_ms=now_ms)
        if vec is not None:
            return PendingTokenResults(functools.partial(
                self._gather_results_vec, verdicts, gather, blp))
        return PendingTokenResults(functools.partial(
            self._gather_results, verdicts, per_shard, results, S, blp))

    def step_routed(self, rows, acq, prio, valid, blp: int, *,
                    now_ms: int):
        """Run the step on pre-routed ``[S, Bl]`` lanes
        (``shard_math.route_requests`` layout) → the in-flight verdicts
        (pass them to :meth:`_gather_results_vec`, or read them with
        ``_to_host``; scatter back with ``shard_math.scatter_verdicts``)."""
        S = self.spec.n_shards
        PV = self.spec.max_params
        PK = self.spec.param_keys_per_shard
        with self._lock:
            return self._step_locked(
                rows, acq, prio, valid, np.zeros((S, blp), np.bool_),
                np.full((S * blp, PV), PK, np.int32),
                np.zeros((S * blp, PV), np.float32), now_ms)

    def _step_locked(self, rows, acq, prio, valid, is_param, prow, pcnt,
                     now_ms: int):
        """Copy one routed batch over, run :func:`cluster_step` and start
        the verdict copy back → ``(host tensors, event)``."""
        put = self._put
        batch = TokenBatch(
            local_rows=put(np.asarray(rows, np.int32).reshape(-1)),
            acquire=put(np.asarray(acq, np.int32).reshape(-1)),
            prioritized=put(np.asarray(prio, np.bool_).reshape(-1)),
            valid=put(np.asarray(valid, np.bool_).reshape(-1)),
            is_param=put(np.asarray(is_param, np.bool_).reshape(-1)),
            param_rows=put(np.asarray(prow, np.int32)),
            param_count=put(np.asarray(pcnt, np.float32)))
        w = self.spec.window
        self.state, verdicts = cluster_step(
            self.spec, self._table, self.state, batch,
            put(self._connected.copy()), put(self._ns_limit.copy()),
            w.index_of(now_ms), now_ms % w.win_ms)
        return start_host_copy(verdicts)

    @staticmethod
    def _to_host(pending) -> List[np.ndarray]:
        """Wait for a step's verdict copy → ``[status, wait_ms,
        remaining]`` numpy arrays."""
        return wait_host_copy(*pending)

    def rows_for_flows(self, flow_ids) -> Optional[np.ndarray]:
        """Global row per flow id (``-1`` = unregistered), vectorized via
        the dense lookup when possible. → None for sparse/non-int ids
        (callers fall back to the dict path). The row→shard math on the
        result is :mod:`~sentinel_tpu_torch.parallel.shard_math`'s."""
        lut = self._fid_lookup
        if lut is None:
            return None
        ids = np.asarray(flow_ids)
        if ids.dtype.kind not in "iu" or ids.ndim != 1:
            return None
        in_rng = (ids >= 0) & (ids < lut.shape[0])
        return np.where(in_rng, lut[np.clip(ids, 0, lut.shape[0] - 1)], -1)

    def _vector_prep(self, flow_ids, acquire, prioritized, n: int, S: int,
                     L: int):
        """Vectorized request grouping (shard_math.route_requests): one
        argsort + scatter instead of per-event dict/append loops. → None
        to fall back to the loop path (sparse ids, non-int input), or
        ``(prep_arrays_or_None, gather_ctx_or_final_results)``."""
        if n == 0:
            return None
        rowg = self.rows_for_flows(flow_ids)
        if rowg is None:
            return None
        lanes, plan = shard_math.route_requests(
            rowg, acquire, prioritized, S, L,
            status_fail=STATUS_FAIL, status_bad=STATUS_BAD_REQUEST,
            status_no_rule=STATUS_NO_RULE_EXISTS)
        if lanes is None:
            return (None, [(int(s), 0, 0) for s in plan.status0])
        return ((lanes.rows, lanes.acquire, lanes.prioritized, lanes.valid,
                 lanes.lanes), plan)

    def _gather_results_vec(self, verdicts, plan, blp):
        """Vectorized inverse of :meth:`_vector_prep`'s grouping."""
        st, wt, rm = self._to_host(verdicts)
        return shard_math.scatter_verdicts(plan, blp, st, wt, rm,
                                           self.spec.n_shards)

    def top_params(self, flow_id: int, *, now_ms: int,
                   top_n: int = 10) -> Dict[object, int]:
        """Most-requested param values of a flow over the current (or,
        right after a rotation, the previous) window — feeds metricList's
        ``topParams`` (``ClusterParamMetric.getTopValues``). Counts are
        REQUESTED acquire sums, host-observed; grant/deny split stays in
        the device counters."""
        with self._lock:
            win = now_ms // (self.spec.window.win_ms
                             * self.spec.window.buckets)
            if win - self._param_hits_win > 1:
                return {}            # tracker is stale by more than a window
            hits = (self._param_hits.get(flow_id)
                    or self._param_hits_prev.get(flow_id) or {})
            return dict(sorted(hits.items(), key=lambda kv: -kv[1])[:top_n])

    def flow_metrics(self, flow_id: int, *, now_ms: int) -> dict:
        """Per-flow current-window snapshot (ClusterMetricNodeGenerator)."""
        with self._lock:
            row = self._flow_to_row.get(flow_id)
            if row is None:
                return {}
            w = self.spec.window
            now_idx = w.index_of(now_ms)
            counters = self.state.flows.counters[row].cpu().numpy()  # [B, E]
            stamps = self.state.flows.stamps[row].cpu().numpy()      # [B]
        delta = (now_idx - stamps.astype(np.int64)).astype(np.int32)
        live = (delta >= 0) & (delta < w.buckets)
        tot = np.where(live[:, None], counters, 0).sum(axis=0)
        return {name: int(tot[i]) for i, name in enumerate(ev.NAMES)}
