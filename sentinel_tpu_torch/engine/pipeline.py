"""The decision pipeline: the slot chain as one device step.

Port of ``sentinel_tpu/engine/pipeline.py``: the scalar path (uniform
acquire, no origins, no prioritized events — the batch the serving
headline sends), the fast path (origins, alt rows and contexts, uniform
acquire) and the general path (anything else), each with or without
occupy (``enable_occupy``: prioritized events may book the next window,
and live bookings count toward the QPS base), with the alt table's
(resource × origin / context) records. The reference order is kept:
every entry walks ``AuthoritySlot → SystemSlot → ParamFlowSlot → FlowSlot
→ DegradeSlot`` and then the user's device slots (``custom_slots``,
:mod:`sentinel_tpu_torch.engine.slots`), and ``StatisticSlot`` records
pass/block AFTER the decision (statistics are post-decision,
``StatisticSlot.java:54-131``); exits record RT/success/exception, feed
the breakers and release the THREAD-grade param keys.

* :func:`decide_entries` — batch of entry events → verdicts + updated state;
* :func:`record_exits`  — batch of completions → updated state;
* :func:`decide_and_record_exits` — both, exits landing after decisions;
* :func:`uncount_reserved` — the host fast path's unused lease tokens
  returned to their window buckets;
* :func:`record_blocks` — BLOCK records of denials decided off the device
  (the host gates').

State is updated IN PLACE where that saves a copy (the window tables, the
thread gauges, the RT histogram) — the port's counterpart of the JAX
package's buffer donation; the small per-rule leaves are replaced. The
functions run eagerly on whatever device the state lives on, without a
host sync: every branch is taken on host values (``times`` are Python
ints computed from the clock, the static flags are Python bools, and
``any_prio`` — whether the batch carries a prioritized event — is read
from the host's copy of the column).

``times`` is ``(idx_s, idx_m, rel_ms, in_win_ms)`` and ``sys_scalars``
``(load1, cpu_usage)`` — the JAX package's packed int32[4]/float32[2]
vectors, as host values.

The same functions run the row-sharded engine
(:mod:`sentinel_tpu_torch.parallel.local_shard`): its row-split fields are
:class:`~sentinel_tpu_torch.parallel.row_blocks.RowBlocks`, read by owner
and written block by block (each block's scatter sees only its own rows),
while the verdicts and the replicated fields are computed on the home
device as on one device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core.errors import BlockReason
from sentinel_tpu_torch.core.registry import ENTRY_NODE_ROW
from sentinel_tpu_torch.engine.slots import DeviceSlotView, run_device_slots
from sentinel_tpu_torch.obs import resource_hist
from sentinel_tpu_torch.ops import scatter_add as sa
from sentinel_tpu_torch.ops.segments import padded_table_gather
from sentinel_tpu_torch.parallel.row_blocks import RowBlocks
from sentinel_tpu_torch.rules import authority as auth_mod
from sentinel_tpu_torch.rules import degrade as deg_mod
from sentinel_tpu_torch.rules import flow as flow_mod
from sentinel_tpu_torch.rules import param_flow as pf_mod
from sentinel_tpu_torch.rules import system as sys_mod
from sentinel_tpu_torch.stats import events as ev
from sentinel_tpu_torch.stats.window import (
    WindowSpec, WindowState, add_one_row, add_rows, add_rows_multi,
    add_rows_vec, extract_rows, init_window, invalidate_rows, refresh_all,
    refresh_rows, restore_rows, row_mask, row_writer, uncount_rows,
    window_sum_rows,
)

Times = Tuple[int, int, int, int]
SysScalars = Tuple[float, float]


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Static engine geometry."""

    rows: int                 # R — main resource rows (row 0 = ENTRY_NODE)
    alt_rows: int             # RA — hashed (resource×origin/context) rows
    second: WindowSpec
    minute: Optional[WindowSpec]
    statistic_max_rt: int
    # HB — per-resource RT histogram buckets (obs/resource_hist.py);
    # 0 = table disabled (state.rt_hist is None)
    hist_buckets: int = 0
    occupy_timeout_ms: int = 500   # OccupyTimeoutProperty (0 = off)
    param_keys: int = 0       # PK — hot-key rows (0 = param flow disabled)
    param_pairs: int = 0      # PV — (rule, value) checks per event


class SentinelState(NamedTuple):
    """All mutable device state (the JAX package's pytree)."""

    second: WindowState           # [R]
    minute: WindowState           # [R] (rows=1 when minute disabled)
    alt_second: WindowState       # [RA]
    threads: torch.Tensor         # int32[R]
    alt_threads: torch.Tensor     # int32[RA]
    flow_dyn: flow_mod.FlowDynState
    breakers: deg_mod.BreakerState
    param_dyn: Optional[pf_mod.ParamDynState] = None   # [PK+1] per key row
    # the registered DeviceSlots' states, in registration order
    custom: Tuple = ()
    rt_hist: Optional[torch.Tensor] = None   # int32[R, HB] cumulative


class RuleSet(NamedTuple):
    """All compiled rule tables; swapped atomically on rule reload."""

    flow_table: flow_mod.FlowRuleTable
    flow_idx: torch.Tensor
    deg_table: deg_mod.DegradeRuleTable
    deg_idx: torch.Tensor
    auth_table: auth_mod.AuthorityRuleTable
    auth_idx: torch.Tensor
    sys_thresholds: sys_mod.SystemThresholds
    param_table: Optional[pf_mod.ParamRuleTable] = None
    # concat(flow_idx, deg_idx) [R, Kf+Kd]: both slots' rule ids in ONE
    # gather over the big row table. Build it with with_joint() (or
    # build_joint_np on the same arrays), never by hand: the consumer
    # splits at flow_idx.shape[1].
    joint_idx: Optional[torch.Tensor] = None

    def with_joint(self) -> "RuleSet":
        return self._replace(joint_idx=torch.cat(
            [self.flow_idx, self.deg_idx], dim=1))

    @staticmethod
    def build_joint_np(flow_idx_np, deg_idx_np):
        return np.concatenate([flow_idx_np, deg_idx_np], axis=1)


class EntryBatch(NamedTuple):
    """Entry events (padding: rows >= R, valid False)."""

    rows: torch.Tensor           # int32[B]
    origin_ids: torch.Tensor     # int32[B] (0 = none)
    origin_rows: torch.Tensor    # int32[B] (>= RA = none)
    context_ids: torch.Tensor    # int32[B]
    chain_rows: torch.Tensor     # int32[B] (>= RA = none)
    acquire: torch.Tensor        # int32[B]
    is_in: torch.Tensor          # bool[B]
    prioritized: torch.Tensor    # bool[B]
    valid: torch.Tensor          # bool[B]
    param_rules: Optional[torch.Tensor] = None   # int32[B, PV] (None: no
    # param slot)
    param_keys: Optional[torch.Tensor] = None    # int32[B, PV]
    # per-event bitmask over the per-resource rule slots: bit k set = the
    # cluster-mode rule in slot k had its token request fail with
    # fallbackToLocalWhenFail, so exactly that rule checks LOCALLY
    # (per-rule FlowRuleChecker.fallbackToLocalOrPass); None = no fallback
    cluster_fallback: Optional[torch.Tensor] = None   # int32[B]
    # False = not counted in the thread gauges (host-leased admissions:
    # the lease pre-charge and each leased exit both carry False). None =
    # all True.
    count_thread: Optional[torch.Tensor] = None    # bool[B]
    # False = a denial records no BLOCK (a lease renewal's pre-charge is a
    # speculative acquire=chunk request, not chunk denied callers). None =
    # all True.
    record_block: Optional[torch.Tensor] = None    # bool[B]


class ExitBatch(NamedTuple):
    rows: torch.Tensor           # int32[B]
    origin_rows: torch.Tensor    # int32[B]
    chain_rows: torch.Tensor     # int32[B]
    acquire: torch.Tensor        # int32[B]
    rt_ms: torch.Tensor          # int32[B]
    error: torch.Tensor          # bool[B]
    is_in: torch.Tensor          # bool[B]
    valid: torch.Tensor          # bool[B]
    param_rules: Optional[torch.Tensor] = None   # int32[B, PV]
    param_keys: Optional[torch.Tensor] = None    # int32[B, PV]
    count_thread: Optional[torch.Tensor] = None    # bool[B] (see EntryBatch)


class Verdicts(NamedTuple):
    allow: torch.Tensor          # bool[B]
    reason: torch.Tensor         # int8[B] (BlockReason codes)
    wait_ms: torch.Tensor        # int32[B]
    # int32 scalar: claim-cascade elements that took the sorted order this
    # step (sort-free steps only, else None)
    sf_overflow: Optional[torch.Tensor] = None


def init_state(spec: EngineSpec, nf: int, nd: int,
               device="cpu") -> SentinelState:
    """Fresh engine state on ``device``."""
    minute_rows = spec.rows if spec.minute else 1
    minute_spec = spec.minute or WindowSpec(1, 1000, track_rt=False)
    return SentinelState(
        second=init_window(spec.second, spec.rows, device=device),
        minute=init_window(minute_spec, minute_rows, device=device),
        alt_second=init_window(spec.second, spec.alt_rows, device=device),
        threads=torch.zeros((spec.rows,), dtype=torch.int32, device=device),
        alt_threads=torch.zeros((spec.alt_rows,), dtype=torch.int32,
                                device=device),
        flow_dyn=flow_mod.init_flow_dyn(nf, spec.second.buckets, spec.rows,
                                        device=device),
        breakers=deg_mod.init_breaker_state(nd, device=device),
        param_dyn=pf_mod.init_param_dyn(spec.param_keys, device=device),
        rt_hist=(torch.zeros((spec.rows, spec.hist_buckets),
                             dtype=torch.int32, device=device)
                 if spec.hist_buckets else None),
    )


def _isum(x: torch.Tensor) -> torch.Tensor:
    """int32 sum that wraps like XLA's (a plain torch sum widens to int64)."""
    return x.sum(dtype=torch.int32)


def _scatter_rows(table, rows: torch.Tensor, events, amounts) -> None:
    """``sa.scatter_add(table, rows, events, amounts)`` on a row-leading
    table, or on each block of a row-block one with the block's own row
    indices (one launch a block)."""
    if isinstance(table, RowBlocks):
        for _i, b, lr in table.owned(rows):
            d = b.device
            sa.scatter_add(b, lr, None if events is None else events.to(d),
                           amounts.to(d))
        return
    sa.scatter_add(table, rows, events, amounts)


def _add_threads(threads, rows: torch.Tensor,
                 amounts: torch.Tensor) -> None:
    """``threads.at[rows].add(amounts, mode="drop")`` through the kernel
    seam (payload mode, one lane)."""
    col = (threads.map(lambda b: b[:, None])
           if isinstance(threads, RowBlocks) else threads[:, None])
    _scatter_rows(col, rows, None, amounts[:, None])


def _add_row(table, row: int, value: torch.Tensor) -> None:
    """``table[row] += value`` in place, on a tensor or in the owner's
    block of row blocks (:meth:`RowBlocks.add_row_`)."""
    if isinstance(table, RowBlocks):
        table.add_row_(row, value)
    else:
        table[row].add_(value)


def _refresh_second(spec: EngineSpec, second: WindowState,
                    rows: torch.Tensor, entry_vec_or_mask: torch.Tensor,
                    now_idx: int) -> WindowState:
    """The second window's lazy reset: a full sweep when B >= 2, else the
    touched rows plus ENTRY only when this batch lands something on it (a
    B == 1 restamp would erase the previous-window reads)."""
    if spec.second.buckets >= 2:
        return refresh_all(spec.second, second, now_idx)
    entry_refresh = torch.where(entry_vec_or_mask.any(), ENTRY_NODE_ROW,
                                spec.rows).to(torch.int32)
    return refresh_rows(spec.second, second,
                        torch.cat([rows, entry_refresh[None]]), now_idx)


def _stat_targets(spec: EngineSpec, origin_rows: torch.Tensor,
                  chain_rows: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """The alt-table recording targets of a batch: the origin rows, then
    the chain rows, padding (``RA``) where the event is invalid → int32[2B]
    (the alt half of the JAX package's ``_stat_targets``; the main half is
    the recorders' own ``main_rec1``/``main_rows``)."""
    pad_a = spec.alt_rows
    return torch.cat([torch.where(valid, origin_rows, pad_a),
                      torch.where(valid, chain_rows, pad_a)])


def _refresh_alt(spec: EngineSpec, alt_second: WindowState,
                 alt_targets: torch.Tensor, now_idx: int) -> WindowState:
    """The alt window's lazy reset: a full sweep when B >= 2, else the
    rows this batch targets."""
    if spec.second.buckets >= 2:
        return refresh_all(spec.second, alt_second, now_idx)
    return refresh_rows(spec.second, alt_second, alt_targets, now_idx)


def decide_entries(
    spec: EngineSpec,
    rules: RuleSet,
    state: SentinelState,
    batch: EntryBatch,
    times: Times,
    sys_scalars: SysScalars,
    *,
    enable_occupy: bool = False,  # occupy-aware step: live bookings fold
    # into the QPS base; the fast and general paths may book
    any_prio: bool = False,      # HOST-KNOWN: the batch has a prioritized
    # event (the reference's lax.cond(any(prioritized)) on the host)
    record_alt: bool = True,     # False = the batch carries no origin/chain
    # rows (host-verified all padding): the alt records are skipped
    scalar_flow: bool = False,   # HOST-VERIFIED scalar preconditions (see
    # flow_check_scalar); implies record_alt=False
    fast_flow: bool = False,     # HOST-VERIFIED fast-path preconditions
    # (uniform acquire >= 1, composite key fits int32; see flow_check_fast)
    skip_auth: bool = False,     # no authority rules loaded
    skip_sys: bool = False,      # no system thresholds set
    scalar_has_rl: bool = True,  # ruleset contains rate-limiter rules
    skip_threads: bool = False,  # nothing loaded reads the thread gauges
    sortfree: bool = False,      # fast/general paths group through the
    # claim cascade (ops/sortfree.py); the verdicts carry sf_overflow
    custom_slots: Tuple = (),    # the registered DeviceSlots, in order
) -> Tuple[SentinelState, Verdicts]:
    """One device step: decide a batch, then record post-decision
    statistics. Gating masks cascade through the slots, so an event
    blocked upstream never consumes downstream quota. The param slot runs
    when the engine has key rows and the batch carries pairs: its rank
    form on the scalar and fast routes (a uniform acquire), its sorted
    form on the general route. The flow slot takes the scalar path
    (``scalar_flow``), the fast path (``fast_flow``) or, with neither, the
    general path. With ``enable_occupy`` an event the flow slot admits by
    booking the next window (occupied) skips the degrade slot and records
    OCCUPIED_PASS (not on the alt rows). The device slots run last."""
    if scalar_flow and (record_alt or fast_flow or any_prio):
        raise ValueError("scalar_flow implies record_alt=False and excludes "
                         "fast_flow and prioritized events")
    R = spec.rows
    RA = spec.alt_rows
    now_idx_s, now_idx_m, rel_now_ms, in_win_ms = times
    load1, cpu_usage = sys_scalars

    live = batch.valid
    if skip_auth:
        auth_ok = torch.ones_like(live)
    else:
        auth_ok = auth_mod.authority_check(
            rules.auth_table, rules.auth_idx, batch.rows, batch.origin_ids,
            live)
    live1 = live & auth_ok
    if skip_sys:
        sys_ok = torch.ones_like(live1)
    else:
        sys_ok = sys_mod.system_check(
            rules.sys_thresholds, spec.second, state.second, state.threads,
            batch.is_in, batch.acquire, live1, now_idx_s, load1, cpu_usage,
            spec.statistic_max_rt)
    live2 = live1 & sys_ok

    # ParamFlowSlot sits between SystemSlot and FlowSlot
    param_dyn = state.param_dyn
    use_param = spec.param_keys and batch.param_rules is not None
    if use_param:
        pcheck = (pf_mod.param_check_scalar if (scalar_flow or fast_flow)
                  else pf_mod.param_check)
        param_dyn, param_ok, param_wait = pcheck(
            rules.param_table, param_dyn, batch.param_rules,
            batch.param_keys, batch.acquire, live2, rel_now_ms)
        live2 = live2 & param_ok
    else:
        param_ok = torch.ones_like(live2)

    flow_bk = deg_bk = None
    if (scalar_flow or fast_flow) and rules.joint_idx is not None:
        kf = rules.flow_idx.shape[1]
        nf = rules.flow_table.active.shape[0] - 1
        nd = rules.deg_table.active.shape[0] - 1
        joint = padded_table_gather(rules.joint_idx, batch.rows, 0)
        in_r = (batch.rows < R)[:, None]
        flow_bk = torch.where(in_r, joint[:, :kf], nf)
        deg_bk = torch.where(in_r, joint[:, kf:], nd)
    main_minute = state.minute if spec.minute else None
    sf_ovf = torch.zeros((), dtype=torch.int32, device=live.device)
    occupied = None      # no occupy-admitted event on this step
    if scalar_flow:
        flow_dyn, flow_ok, wait_ms = flow_mod.flow_check_scalar(
            rules.flow_table, state.flow_dyn, rules.flow_idx, spec.second,
            state.second, state.threads, batch.rows, batch.acquire, live2,
            now_idx_s, rel_now_ms, minute_spec=spec.minute,
            main_minute=main_minute, now_idx_m=now_idx_m,
            has_rate_limiter=scalar_has_rl, rules_bk=flow_bk,
            occupy_base=enable_occupy)
    else:
        fview = flow_mod.FlowBatchView(
            rows=batch.rows, origin_ids=batch.origin_ids,
            origin_rows=batch.origin_rows, context_ids=batch.context_ids,
            chain_rows=batch.chain_rows, acquire=batch.acquire, valid=live2,
            cluster_fallback=(batch.cluster_fallback
                              if batch.cluster_fallback is not None
                              else torch.zeros_like(batch.rows)),
            prioritized=batch.prioritized)
        args = (rules.flow_table, state.flow_dyn, rules.flow_idx,
                spec.second, state.second, state.alt_second, state.threads,
                state.alt_threads, fview, now_idx_s, rel_now_ms)
        common = dict(minute_spec=spec.minute, main_minute=main_minute,
                      now_idx_m=now_idx_m, has_thread_rules=not skip_threads,
                      sortfree=sortfree, in_win_ms=in_win_ms,
                      occupy_timeout_ms=spec.occupy_timeout_ms,
                      enable_occupy=enable_occupy, any_prio=any_prio)
        if fast_flow:
            flow_dyn, flow_ok, wait_ms, occ, sf_ovf = \
                flow_mod.flow_check_fast(
                    *args, has_rate_limiter=scalar_has_rl, rules_bk=flow_bk,
                    **common)
        else:
            flow_dyn, flow_ok, wait_ms, occ, sf_ovf = flow_mod.flow_check(
                *args, **common)
        if enable_occupy:
            occupied = occ
    live3 = live2 & flow_ok
    # the degrade slot is origin-independent: one check serves every path
    # (deg_mod.degrade_entry_check says why it equals the sorted form).
    # Occupied (PriorityWait) events bypass it: the reference's
    # PriorityWaitException ends the slot chain before DegradeSlot.entry.
    breakers, deg_ok = deg_mod.degrade_entry_check(
        rules.deg_table, state.breakers, rules.deg_idx, batch.rows,
        live3 if occupied is None else live3 & ~occupied, rel_now_ms,
        rules_bk=deg_bk)
    if occupied is not None:
        deg_ok = deg_ok | occupied

    # the user's DeviceSlots, after the built-in cascade; the window is
    # read before this step records into it
    custom_states = state.custom
    if custom_slots:
        pass_counts = window_sum_rows(
            spec.second, state.second, torch.clamp(batch.rows, max=R - 1),
            ev.PASS, now_idx_s).float()
        view = DeviceSlotView(
            rows=batch.rows, origin_ids=batch.origin_ids,
            acquire=batch.acquire, is_in=batch.is_in,
            prioritized=batch.prioritized, live=live3 & deg_ok,
            now_idx_s=now_idx_s, rel_now_ms=rel_now_ms,
            pass_counts=pass_counts)
        custom_states, custom_ok, custom_reason = run_device_slots(
            custom_slots, state.custom, view)
    else:
        custom_ok = torch.ones_like(live)

    allow = live & auth_ok & sys_ok & param_ok & flow_ok & deg_ok & custom_ok
    reason = torch.zeros(batch.rows.shape, dtype=torch.int8,
                         device=batch.rows.device)
    if custom_slots:
        reason = torch.where(~custom_ok, custom_reason, reason)
    reason = torch.where(~deg_ok, BlockReason.DEGRADE, reason)
    reason = torch.where(~flow_ok, BlockReason.FLOW, reason)
    reason = torch.where(~param_ok, BlockReason.PARAM_FLOW, reason)
    reason = torch.where(~sys_ok, BlockReason.SYSTEM, reason)
    reason = torch.where(~auth_ok, BlockReason.AUTHORITY, reason)
    reason = torch.where(~batch.valid, BlockReason.NONE, reason)
    wait_ms = (torch.maximum(wait_ms, param_wait) if use_param
               else torch.clamp(wait_ms, min=0))
    wait_ms = torch.where(allow, wait_ms, 0)

    # ---- StatisticSlot.entry (post-decision recording) ----
    passed = allow & batch.valid
    blocked = ~allow & batch.valid
    # an occupied event's pass belongs to the booked window: it records
    # OCCUPIED_PASS now, not PASS; a denial with record_block False
    # records nothing
    pass_now = passed
    occ1 = None
    if occupied is not None:
        occ1 = occupied & passed
        pass_now = passed & ~occupied
    blocked_rec = (blocked if batch.record_block is None
                   else blocked & batch.record_block)
    # each event lands in exactly ONE lane, so the per-row record is one
    # fused scatter of B indices; the global ENTRY row is a reduction plus
    # one single-row update
    rec1 = pass_now | blocked_rec
    ev_ids1 = torch.where(pass_now, ev.PASS, ev.BLOCK)
    if occ1 is not None:
        rec1 = rec1 | occ1
        ev_ids1 = torch.where(occ1, ev.OCCUPIED_PASS, ev_ids1)
    ev_ids1 = ev_ids1.to(torch.int32)
    acq = batch.acquire
    rec_amt1 = torch.where(rec1, acq, 0)
    main_rec1 = torch.where(rec1, batch.rows, R)

    ein = batch.is_in
    entry_vec = torch.zeros((ev.NUM_EVENTS,), dtype=torch.int32,
                            device=acq.device)
    entry_vec[ev.PASS] = _isum(torch.where(pass_now & ein, acq, 0))
    if occ1 is not None:
        entry_vec[ev.OCCUPIED_PASS] = _isum(torch.where(occ1 & ein, acq, 0))
    entry_vec[ev.BLOCK] = _isum(torch.where(blocked_rec & ein, acq, 0))

    second = _refresh_second(spec, state.second, main_rec1, entry_vec != 0,
                             now_idx_s)
    add_rows_multi(spec.second, second, main_rec1, ev_ids1, rec_amt1,
                   now_idx_s)
    add_one_row(spec.second, second, ENTRY_NODE_ROW, entry_vec, now_idx_s)

    # alt rows (origin + chain hashes), one scatter of 2B lanes: every
    # event is recorded, so the targets are the valid events' rows
    alt_second = state.alt_second
    if record_alt:
        alt_targets = _stat_targets(spec, batch.origin_rows,
                                    batch.chain_rows, batch.valid)
        ev_ids2 = torch.cat([ev_ids1, ev_ids1])
        alt_second = _refresh_alt(spec, alt_second, alt_targets, now_idx_s)
        # one scatter on every route: the JAX package's one-hot histogram
        # branch for small alt tables (fast route, RA <= 4096) adds the
        # same sum under its uniform acquire, and the kernel's plan takes
        # the shared-memory path for such a table by itself
        acq2 = torch.cat([acq, acq])
        alt_rec = alt_targets
        if occ1 is not None or batch.record_block is not None:
            # no OCCUPIED lane on the alt rows, no unrecorded denials
            alt_mask1 = pass_now | blocked_rec
            alt_rec = torch.where(torch.cat([alt_mask1, alt_mask1]),
                                  alt_targets, RA)
        alt_amt = torch.where(alt_rec < RA, acq2, 0)
        add_rows_multi(spec.second, alt_second, alt_rec, ev_ids2,
                       alt_amt, now_idx_s)

    if spec.minute:
        refresh_all(spec.minute, state.minute, now_idx_m)
        add_rows_multi(spec.minute, state.minute, main_rec1, ev_ids1,
                       rec_amt1, now_idx_m)
        add_one_row(spec.minute, state.minute, ENTRY_NODE_ROW, entry_vec,
                    now_idx_m)

    if not skip_threads:
        # +1 per admitted entry (reference curThreadNum); leased
        # admissions opt out (count_thread)
        thr1 = (passed if batch.count_thread is None
                else passed & batch.count_thread)
        _add_threads(state.threads, torch.where(passed, batch.rows, R),
                     thr1.to(torch.int32))
        _add_row(state.threads, ENTRY_NODE_ROW,
                 _isum((thr1 & ein).to(torch.int32)))
        if record_alt:
            pass2 = torch.cat([passed, passed])
            _add_threads(state.alt_threads,
                         torch.where(pass2, alt_targets, RA),
                         torch.cat([thr1, thr1]).to(torch.int32))
        if use_param:
            param_dyn = pf_mod.param_thread_update(
                rules.param_table, param_dyn, batch.param_rules,
                batch.param_keys, passed, +1)

    new_state = state._replace(second=second, alt_second=alt_second,
                               flow_dyn=flow_dyn, breakers=breakers,
                               param_dyn=param_dyn, custom=custom_states)
    return new_state, Verdicts(allow=allow, reason=reason,
                               wait_ms=wait_ms.to(torch.int32),
                               sf_overflow=sf_ovf if sortfree else None)


def record_exits(
    spec: EngineSpec,
    rules: RuleSet,
    state: SentinelState,
    batch: ExitBatch,
    times: Times,
    *,
    record_alt: bool = True,
    skip_threads: bool = False,
) -> SentinelState:
    """Completion step: ``StatisticSlot.exit`` (rt/success/exception and
    the thread decrement, for the node, its origin and chain rows
    (``record_alt``) and ENTRY) then ``DegradeSlot.exit`` (breaker feed),
    then the per-resource RT histogram."""
    R = spec.rows
    now_idx_s, now_idx_m, rel_now_ms, _in_win_ms = times

    main_rows = torch.where(batch.valid, batch.rows, R)
    acq1 = torch.where(batch.valid, batch.acquire, 0)
    err1 = torch.where(batch.error, acq1, 0)
    rt1 = batch.rt_ms
    ein = batch.valid & batch.is_in

    # an exit can record BOTH SUCCESS and EXCEPTION: the per-row record is
    # one payload-mode scatter of full event-lane vectors
    payload = torch.zeros((batch.rows.shape[0], ev.NUM_EVENTS),
                          dtype=torch.int32, device=acq1.device)
    payload[:, ev.SUCCESS] = acq1
    payload[:, ev.EXCEPTION] = err1

    entry_vec = torch.zeros((ev.NUM_EVENTS,), dtype=torch.int32,
                            device=acq1.device)
    entry_vec[ev.SUCCESS] = _isum(torch.where(ein, acq1, 0))
    entry_vec[ev.EXCEPTION] = _isum(torch.where(ein, err1, 0))
    # float32 BEFORE the sum: the ENTRY aggregate overflows int32 within a
    # single large batch
    entry_rt_add = torch.where(ein, rt1, 0).to(torch.float32).sum()
    entry_rt_min = torch.where(ein, rt1, 2 ** 31 - 1).min()

    second = _refresh_second(spec, state.second, main_rows, ein, now_idx_s)
    add_rows_vec(spec.second, second, main_rows, payload, now_idx_s,
                 rt_ms=rt1, rt_valid=batch.valid)
    add_one_row(spec.second, second, ENTRY_NODE_ROW, entry_vec, now_idx_s,
                rt_add=entry_rt_add, rt_min=entry_rt_min)
    alt_second = state.alt_second
    if record_alt:
        alt_targets = _stat_targets(spec, batch.origin_rows,
                                    batch.chain_rows, batch.valid)
        alt_second = _refresh_alt(spec, alt_second, alt_targets, now_idx_s)
        valid2 = torch.cat([batch.valid, batch.valid])
        add_rows_vec(spec.second, alt_second, alt_targets,
                     torch.cat([payload, payload]), now_idx_s,
                     rt_ms=torch.cat([rt1, rt1]), rt_valid=valid2)
    if spec.minute:
        refresh_all(spec.minute, state.minute, now_idx_m)
        add_rows_vec(spec.minute, state.minute, main_rows, payload,
                     now_idx_m, rt_ms=rt1, rt_valid=batch.valid)
        add_one_row(spec.minute, state.minute, ENTRY_NODE_ROW, entry_vec,
                    now_idx_m, rt_add=entry_rt_add, rt_min=entry_rt_min)

    if not skip_threads:
        ct1 = (batch.valid if batch.count_thread is None
               else batch.valid & batch.count_thread)
        dec1 = ct1.to(torch.int32)
        _add_threads(state.threads, main_rows, -dec1)
        _add_row(state.threads, ENTRY_NODE_ROW,
                 -_isum((ein & ct1).to(torch.int32)))
        state.threads.clamp_(min=0)
        if record_alt:
            _add_threads(state.alt_threads, alt_targets,
                         -torch.cat([dec1, dec1]))
            state.alt_threads.clamp_(min=0)
        if spec.param_keys and batch.param_rules is not None:
            pf_mod.param_thread_update(
                rules.param_table, state.param_dyn, batch.param_rules,
                batch.param_keys, batch.valid, -1)

    breakers = deg_mod.degrade_exit_feed(
        rules.deg_table, state.breakers, rules.deg_idx, batch.rows,
        batch.rt_ms, batch.error, batch.valid, rel_now_ms)

    if spec.hist_buckets:
        # one +1 per valid exit at [row, log2 ms bucket] (completions, not
        # acquire-weighted); invalid lanes ride the pad row and drop
        bidx = resource_hist.bucket_index(rt1, spec.hist_buckets)
        _scatter_rows(state.rt_hist, main_rows, bidx,
                      batch.valid.to(torch.int32))

    return state._replace(second=second, alt_second=alt_second,
                          breakers=breakers)


def decide_and_record_exits(
    spec: EngineSpec,
    rules: RuleSet,
    state: SentinelState,
    entry_batch: EntryBatch,
    exit_batch: ExitBatch,
    times: Times,
    sys_scalars: SysScalars,
    *,
    enable_occupy: bool = False,
    any_prio: bool = False,
    record_alt: bool = True,
    scalar_flow: bool = False,
    fast_flow: bool = False,
    skip_auth: bool = False,
    skip_sys: bool = False,
    scalar_has_rl: bool = True,
    skip_threads: bool = False,
    sortfree: bool = False,
    custom_slots: Tuple = (),
) -> Tuple[SentinelState, Verdicts]:
    """Fused entry+exit step: this step's decisions, then the previous
    step's completions — identical to :func:`decide_entries` followed by
    :func:`record_exits` at the same ``times`` (``record_alt`` serves
    both halves)."""
    state, verdicts = decide_entries(
        spec, rules, state, entry_batch, times, sys_scalars,
        enable_occupy=enable_occupy, any_prio=any_prio,
        record_alt=record_alt,
        scalar_flow=scalar_flow, fast_flow=fast_flow, skip_auth=skip_auth,
        skip_sys=skip_sys, scalar_has_rl=scalar_has_rl,
        skip_threads=skip_threads, sortfree=sortfree,
        custom_slots=custom_slots)
    state = record_exits(spec, rules, state, exit_batch, times,
                         record_alt=record_alt, skip_threads=skip_threads)
    return state, verdicts


def record_blocks(spec: EngineSpec, state: SentinelState, rows: torch.Tensor,
                  origin_rows: torch.Tensor, chain_rows: torch.Tensor,
                  acquire: torch.Tensor, is_in: torch.Tensor,
                  valid: torch.Tensor, times: Times) -> SentinelState:
    """Record BLOCK events decided OFF the device (the host gates'
    denials; the reference's StatisticSlot counts them like any other
    BlockException): the event's row and, for inbound events, the ENTRY
    row in the second and minute windows, and its origin and chain rows
    in the alt window. Padding rows (>= R, alt >= RA) drop."""
    now_idx_s, now_idx_m = times[0], times[1]
    R, RA = spec.rows, spec.alt_rows
    main_targets = torch.cat([torch.where(valid, rows, R),
                              torch.where(valid & is_in, ENTRY_NODE_ROW, R)
                              .to(torch.int32)])
    alt_targets = _stat_targets(spec, origin_rows, chain_rows, valid)
    amt = torch.where(valid, acquire, 0)
    amt2 = torch.cat([amt, amt])
    if spec.second.buckets >= 2:
        second = refresh_all(spec.second, state.second, now_idx_s)
        alt_second = refresh_all(spec.second, state.alt_second, now_idx_s)
    else:
        second = refresh_rows(spec.second, state.second, main_targets,
                              now_idx_s)
        alt_second = refresh_rows(spec.second, state.alt_second, alt_targets,
                                  now_idx_s)
    add_rows(spec.second, second, main_targets, ev.BLOCK, amt2, now_idx_s)
    add_rows(spec.second, alt_second, alt_targets, ev.BLOCK, amt2, now_idx_s)
    if spec.minute:
        refresh_all(spec.minute, state.minute, now_idx_m)
        add_rows(spec.minute, state.minute, main_targets, ev.BLOCK, amt2,
                 now_idx_m)
    return state._replace(second=second, alt_second=alt_second)


def uncount_reserved(spec: EngineSpec, state: SentinelState,
                     rows: torch.Tensor, sec_idx: torch.Tensor,
                     min_idx: torch.Tensor,
                     amounts: torch.Tensor) -> SentinelState:
    """Return unused host-lease tokens to their window buckets: a lease
    pre-charge recorded PASS for its whole chunk up front, so the
    remainder of an expired lease is subtracted back (only from buckets
    that still hold the stamp, :func:`stats.window.uncount_rows`), in the
    second window and the minute window. Padding rows >= R drop."""
    uncount_rows(spec.second, state.second, rows, sec_idx, ev.PASS, amounts)
    if spec.minute:
        uncount_rows(spec.minute, state.minute, rows, min_idx, ev.PASS,
                     amounts)
    return state


def invalidate_resource_rows(spec: EngineSpec, state: SentinelState,
                             rows: torch.Tensor,
                             alt_rows: torch.Tensor) -> SentinelState:
    """Forget recycled rows' stats (registry eviction hygiene): window
    stamps to NEVER, thread gauges, RT histogram rows and occupy bookings
    to their initial values — for ``rows`` and for ``alt_rows``, the
    hashed (resource × origin/context) rows the evicted resources touched
    (a recycled row whose new (resource, origin) pair hashes to the same
    alt row must not inherit the old pair's counts). Padding rows >= R
    (alt: >= RA) drop."""
    invalidate_rows(spec.second, state.second, rows)
    if spec.minute:
        invalidate_rows(spec.minute, state.minute, rows)
    occ = state.flow_dyn
    _clear_rows(rows, [(state.threads, 0), (state.rt_hist, 0),
                       (occ.occupied_count, 0.0),
                       (occ.occupied_window, -(2 ** 30))])
    invalidate_rows(spec.second, state.alt_second, alt_rows)
    _clear_rows(alt_rows, [(state.alt_threads, 0)])
    return state


def _clear_rows(rows: torch.Tensor, fills) -> None:
    """Set ``rows`` of each ``(table, value)`` of ``fills`` to ``value``
    (tables of one row layout, None skipped; padding rows drop): one
    dense row mask, or one a block on row-block tables."""
    fills = [(t, v) for t, v in fills if t is not None]
    layout = fills[0][0]
    if isinstance(layout, RowBlocks):
        for i, _b, lr in layout.owned(rows):
            hit = row_mask(lr, layout.per)
            for t, v in fills:
                blk = t.blocks[i]
                blk.masked_fill_(hit.view((-1,) + (1,) * (blk.dim() - 1)),
                                 v)
        return
    hit = row_mask(rows, layout.shape[0])
    for t, v in fills:
        t.masked_fill_(hit.view((-1,) + (1,) * (t.dim() - 1)), v)


class ResourceRowSlice(NamedTuple):
    """One batch of demoted rows' complete per-row state — everything
    :func:`invalidate_resource_rows` destroys, gathered FIRST so the cold
    tier (``sentinel_tpu_torch/tiering/``) can hold it on the host and a
    later promotion restores the row bit-identically. Window stamps and
    occupy target windows are absolute indices, so the payload needs no
    rebasing. ``alt_*`` leaves carry the hashed (resource ×
    origin/context) slots the demoted resources touched, keyed by (kind,
    key id) on the host so promotion can re-hash them to the new row's
    slots."""

    second: WindowState            # [K, ...] per-row second-window slice
    minute: WindowState            # [K, ...] (row 0 of the stub when off)
    threads: torch.Tensor          # int32[K]
    occ_cnt: torch.Tensor          # float32[K, B+1] occupy booking ring
    occ_win: torch.Tensor          # int32[K, B+1]
    alt_second: WindowState        # [KA, ...] alt-window slices
    alt_threads: torch.Tensor      # int32[KA]
    rt_hist: Optional[torch.Tensor] = None   # int32[K, HB] (None: no table)


def extract_resource_rows(spec: EngineSpec, state: SentinelState,
                          rows: torch.Tensor,
                          alt_rows: torch.Tensor) -> ResourceRowSlice:
    """Gather the demotion payload for ``rows`` (+ their ``alt_rows``)
    out of the live state, into FRESH tensors: the engine updates its
    state in place, so the invalidate dispatched right after must not be
    read back through the payload. No wait on the device."""
    r = torch.clamp(rows, 0, spec.rows - 1).long()
    ra = torch.clamp(alt_rows, 0, spec.alt_rows - 1).long()
    if spec.minute:
        minute = extract_rows(spec.minute, state.minute, rows)
    else:   # minute ring off: placeholder slice (ignored at restore)
        minute = extract_rows(spec.second, state.minute,
                              torch.zeros_like(rows))
    return ResourceRowSlice(
        second=extract_rows(spec.second, state.second, rows),
        minute=minute,
        threads=state.threads[r],
        occ_cnt=state.flow_dyn.occupied_count[r],
        occ_win=state.flow_dyn.occupied_window[r],
        alt_second=extract_rows(spec.second, state.alt_second, alt_rows),
        alt_threads=state.alt_threads[ra],
        rt_hist=state.rt_hist[r] if state.rt_hist is not None else None)


def restore_resource_rows(spec: EngineSpec, state: SentinelState,
                          rows: torch.Tensor, payload: ResourceRowSlice,
                          alt_rows: torch.Tensor) -> SentinelState:
    """Scatter a promotion payload into freshly (re)allocated ``rows``,
    in place. The inverse of :func:`extract_resource_rows` modulo two
    asymmetries: ``alt_rows`` are the NEW rows' hashed slots (a collision
    with a live pair overwrites that pair's alt slice, the merging the
    hash already implies), and bookings that straddled a rule reload
    while cold were settled on the host first
    (``tiering/coldtier.settle_entry_np``). Padding rows >= R (alt:
    >= RA) drop. Two promoted keys' re-hashed alt slots may coincide:
    the LAST lane's slice wins, as in the reference's scatter on the CPU
    (:class:`~sentinel_tpu_torch.stats.window.RowWriter`)."""
    main = row_writer(rows, state.threads)
    restore_rows(spec.second, state.second, rows, payload.second, main)
    if spec.minute:
        restore_rows(spec.minute, state.minute, rows, payload.minute, main)
    main.write(state.flow_dyn.occupied_count, payload.occ_cnt)
    main.write(state.flow_dyn.occupied_window, payload.occ_win)
    if state.rt_hist is not None and payload.rt_hist is not None:
        main.write(state.rt_hist, payload.rt_hist)
    main.write(state.threads, payload.threads)
    alt = row_writer(alt_rows, state.alt_threads)
    restore_rows(spec.second, state.alt_second, alt_rows,
                 payload.alt_second, alt)
    alt.write(state.alt_threads, payload.alt_threads)
    return state
