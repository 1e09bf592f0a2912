"""Flow rules: FlowSlot / FlowRuleChecker / traffic-shaping controllers.

Port of ``sentinel_tpu/rules/flow.py``: the rule object, the compiler and
the three admission paths — :func:`flow_check_scalar` (no origins, no
prioritized events, uniform acquire; it may read live occupy bookings),
:func:`flow_check_fast` (origins, alt rows and CHAIN contexts live,
uniform acquire, rank closed forms) and :func:`flow_check` (anything:
key-grouped segments with greedy prefix admission). The last two take
``enable_occupy``: landed bookings fold into the QPS base, and a denied
prioritized event may book the next window (``tryOccupyNext``).
Reference semantics (``sentinel-core/.../slots/block/flow/``):
``DefaultController.canPass:50-76``, ``RateLimiterController:30-90``,
``WarmUpController:66-190`` and ``FlowRuleChecker``'s rule-set semantics.

Rules compile host-side (numpy, identical to the JAX package) into a
struct-of-arrays :class:`FlowRuleTable` plus a per-resource gather table
``rule_idx[R, K]``; the check is one function over the batch's
(event × rule-slot) pairs. Blocking behaviours return ``wait_ms`` verdicts
instead of sleeping the caller.

Parity notes (the port must reproduce the JAX package bit for bit):

* int32 arithmetic wraps, floor ``//`` is ``torch.div(...,
  rounding_mode="floor")``; float32 → int32 casts saturate as XLA's do.
* The reference's XLA build contracts ``a * b + c`` into a fused
  multiply-add in the warm-up token math; :func:`_fma_f32` computes the
  same correctly rounded FMA (in float64 with round-to-odd), so warm-up
  limits agree to the bit.
* The packed per-rule gather bitcasts float32 columns to int32 with
  ``Tensor.view`` (exact round trip), as ``lax.bitcast_convert_type`` did.
* ``lax.cond(overflow, sorted, hashed)`` of the sort-free variants becomes
  both branches and a ``torch.where`` on the device (see
  :mod:`ops.sortfree`); a ``mode="drop"`` scatter sends its dropped lanes
  to spare slots (:func:`ops.segments.scatter_reduce_drop`).
* ``lax.cond(any(prioritized), attempt, no_attempt)`` of the occupy
  variants is a host flag, ``any_prio``: the runtime holds the
  prioritized column in numpy, so the branch is taken on the host (exact:
  padding lanes are never prioritized). The attempt's bookings are one
  float32 scatter-add through the kernel seam.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.ops import scatter_add as sa
from sentinel_tpu_torch.ops import segments as seg
from sentinel_tpu_torch.ops import sortfree as sfo
from sentinel_tpu_torch.stats import events as ev
from sentinel_tpu_torch.stats.window import (
    WindowSpec, WindowState, prev_window_sum_rows, window_sum_all,
    window_sum_rows, wrap_i32,
)

# Grades (reference RuleConstant.FLOW_GRADE_*)
GRADE_THREAD = 0
GRADE_QPS = 1
# Strategies (RuleConstant.STRATEGY_*)
STRATEGY_DIRECT = 0
STRATEGY_RELATE = 1
STRATEGY_CHAIN = 2
# Control behaviors (RuleConstant.CONTROL_BEHAVIOR_*)
BEHAVIOR_DEFAULT = 0
BEHAVIOR_WARM_UP = 1
BEHAVIOR_RATE_LIMITER = 2
BEHAVIOR_WARM_UP_RATE_LIMITER = 3

# limit_origin sentinel codes (limitApp strings "default"/"other")
LIMIT_DEFAULT = -1
LIMIT_OTHER = -2

# Stat-row selection kinds (compiled from limitApp × strategy)
SEL_MAIN = 0    # resource's global row            (default + DIRECT)
SEL_ORIGIN = 1  # event's per-origin row           (specific origin / other)
SEL_REF = 2     # related resource's global row    (RELATE)
SEL_CHAIN = 3   # event's per-context row          (CHAIN, context == refResource)


@dataclasses.dataclass
class FlowRule:
    """Host-facing rule object (reference ``FlowRule.java`` field parity)."""

    resource: str
    count: float
    grade: int = GRADE_QPS
    limit_app: str = "default"
    strategy: int = STRATEGY_DIRECT
    ref_resource: str = ""
    control_behavior: int = BEHAVIOR_DEFAULT
    warm_up_period_sec: int = 10
    max_queueing_time_ms: int = 500
    cluster_mode: bool = False
    cluster_flow_id: int = 0
    cluster_threshold_type: int = 0      # 0 AVG_LOCAL, 1 GLOBAL
    cluster_fallback_to_local: bool = True

    def is_valid(self) -> bool:
        if not self.resource or self.count < 0:
            return False
        if self.grade not in (GRADE_THREAD, GRADE_QPS):
            return False
        if self.strategy in (STRATEGY_RELATE, STRATEGY_CHAIN) and not self.ref_resource:
            return False
        if self.control_behavior == BEHAVIOR_WARM_UP and self.warm_up_period_sec <= 0:
            return False
        return True



class FlowRuleTable(NamedTuple):
    """Static (per rule-load) device arrays, NF+1 rows; last row = inactive
    sentinel so padded gathers are harmless."""

    active: torch.Tensor          # bool[NF+1]
    grade: torch.Tensor           # int32
    count: torch.Tensor           # float32
    behavior: torch.Tensor        # int32
    sel_kind: torch.Tensor        # int32 (SEL_*)
    ref_row: torch.Tensor         # int32 — main-table row for SEL_REF
    ref_context: torch.Tensor     # int32 — required context id for SEL_CHAIN
    limit_origin: torch.Tensor    # int32 — LIMIT_DEFAULT/LIMIT_OTHER/origin id
    max_queue_ms: torch.Tensor    # int32
    # warm-up precomputed constants (WarmUpController ctor math)
    warning_token: torch.Tensor   # float32
    max_token: torch.Tensor       # float32
    slope: torch.Tensor           # float32
    cold_factor: torch.Tensor     # float32
    sync_row: torch.Tensor        # int32 — main-table row used for token sync
    cluster_mode: torch.Tensor    # bool


class FlowDynState(NamedTuple):
    """Per-rule mutable shaping state (device), plus the occupy booking
    ring (``occupied_*``, keyed by resource row; slot ``w % (B+1)`` holds
    the bookings granted for window ``w``)."""

    latest_passed_ms: torch.Tensor   # int32[NF+1] — rel-ms pacing clock
    stored_tokens: torch.Tensor      # float32[NF+1]
    last_filled_sec: torch.Tensor    # int32[NF+1] — rel seconds
    occupied_count: torch.Tensor     # float32[R, B+1]
    occupied_window: torch.Tensor    # int32[R, B+1]


class CompiledFlowRules(NamedTuple):
    """Host-side compile output."""

    table: FlowRuleTable
    rule_idx: torch.Tensor          # int32[R, K] → table row, NF = none
    rules: Tuple[FlowRule, ...]     # original objects, index-aligned with table
    num_active: int
    k_used: int = 1                 # max rules on any ONE resource
    rule_idx_np: Optional[np.ndarray] = None


def init_flow_dyn(nf: int, buckets: int = 2, rows: int = 1,
                  device="cpu") -> FlowDynState:
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)
    return FlowDynState(
        latest_passed_ms=full((nf + 1,), -(2 ** 30), torch.int32),
        stored_tokens=full((nf + 1,), 0.0, torch.float32),
        last_filled_sec=full((nf + 1,), -(2 ** 30), torch.int32),
        occupied_count=full((rows, buckets + 1), 0.0, torch.float32),
        occupied_window=full((rows, buckets + 1), -(2 ** 30), torch.int32),
    )


def compile_flow_rules(rules: Sequence[FlowRule], *, resource_registry,
                       context_registry, capacity: int, k_per_resource: int,
                       num_rows: int, cold_factor: float = 3.0,
                       origin_registry=None,
                       device="cpu") -> CompiledFlowRules:
    """Validate + vectorize rules (the ``FlowRuleUtil`` analog).

    Origin-specific ``limit_app`` strings are interned through
    ``origin_registry`` (pinned so ids stay stable while referenced).
    Resources named by rules are pinned in the resource registry.
    Invalid rules are skipped (reference logs and skips); rules beyond
    ``capacity`` or more than ``k_per_resource`` per resource raise — unlike
    the reference's silent 6000-chain cap, overflow here is loud.
    """
    valid = [r for r in rules if r.is_valid()]
    if len(valid) > capacity:
        raise ValueError(f"too many flow rules: {len(valid)} > capacity {capacity}")

    nf = capacity
    active = np.zeros(nf + 1, np.bool_)
    grade = np.zeros(nf + 1, np.int32)
    count = np.zeros(nf + 1, np.float32)
    behavior = np.zeros(nf + 1, np.int32)
    sel_kind = np.zeros(nf + 1, np.int32)
    ref_row = np.zeros(nf + 1, np.int32)
    ref_context = np.full(nf + 1, -1, np.int32)
    limit_origin = np.full(nf + 1, LIMIT_DEFAULT, np.int32)
    max_queue_ms = np.zeros(nf + 1, np.int32)
    warning_token = np.zeros(nf + 1, np.float32)
    max_token = np.zeros(nf + 1, np.float32)
    slope = np.zeros(nf + 1, np.float32)
    cold_f = np.full(nf + 1, cold_factor, np.float32)
    sync_row = np.full(nf + 1, num_rows, np.int32)
    cluster_mode = np.zeros(nf + 1, np.bool_)

    rule_idx = np.full((num_rows, k_per_resource), nf, np.int32)
    slots_used = {}

    for j, r in enumerate(valid):
        row = resource_registry.pin(r.resource)
        k = slots_used.get(row, 0)
        if k >= k_per_resource:
            raise ValueError(
                f"more than {k_per_resource} flow rules for resource {r.resource!r}; "
                f"raise max_rules_per_resource")
        slots_used[row] = k + 1
        rule_idx[row, k] = j

        active[j] = True
        grade[j] = r.grade
        count[j] = r.count
        behavior[j] = r.control_behavior
        max_queue_ms[j] = r.max_queueing_time_ms
        cluster_mode[j] = r.cluster_mode
        sync_row[j] = row

        la = r.limit_app or "default"
        if la == "default":
            limit_origin[j] = LIMIT_DEFAULT
        elif la == "other":
            limit_origin[j] = LIMIT_OTHER
        else:
            if origin_registry is None:
                raise ValueError("origin-specific rule needs an origin registry")
            limit_origin[j] = origin_registry.pin(la)

        if r.strategy == STRATEGY_RELATE:
            sel_kind[j] = SEL_REF
            ref_row[j] = resource_registry.pin(r.ref_resource)
            sync_row[j] = ref_row[j]
        elif r.strategy == STRATEGY_CHAIN:
            sel_kind[j] = SEL_CHAIN
            ref_context[j] = context_registry.pin(r.ref_resource)
        elif la in ("default",):
            sel_kind[j] = SEL_MAIN
        else:
            # specific origin or "other" + DIRECT → the event's origin row
            # (FlowRuleChecker.java:137-141,154-158)
            sel_kind[j] = SEL_ORIGIN

        if r.control_behavior in (BEHAVIOR_WARM_UP, BEHAVIOR_WARM_UP_RATE_LIMITER):
            # WarmUpController.java:66-90 constructor math
            wt = (r.warm_up_period_sec * r.count) / (cold_factor - 1.0)
            mt = wt + 2.0 * r.warm_up_period_sec * r.count / (1.0 + cold_factor)
            warning_token[j] = wt
            max_token[j] = mt
            slope[j] = (cold_factor - 1.0) / r.count / max(mt - wt, 1e-9)

    table = FlowRuleTable(*(
        torch.from_numpy(a).to(device) for a in (
            active, grade, count, behavior, sel_kind, ref_row, ref_context,
            limit_origin, max_queue_ms, warning_token, max_token, slope,
            cold_f, sync_row, cluster_mode)))
    return CompiledFlowRules(table=table,
                             rule_idx=torch.from_numpy(rule_idx).to(device),
                             rules=tuple(valid), num_active=len(valid),
                             k_used=max(1, max(slots_used.values(),
                                               default=0)),
                             rule_idx_np=rule_idx)


# ---------------------------------------------------------------------------
# Device-side check (scalar admission path)
# ---------------------------------------------------------------------------

_INF = float("inf")


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding, as a fused
    multiply-add). The float64 product of two float32 values is exact;
    the float64 sum is made round-to-odd (nudged one ulp toward the lost
    error when that error is nonzero and the result is even), which makes
    the final rounding to float32 correct (53 >= 24 + 2 bits)."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    pp = s - c64
    cc = s - pp
    err = (p - pp) + (c64 - cc)                  # TwoSum: exact error
    even = (s.view(torch.int64) & 1) == 0
    nudge = torch.isfinite(s) & (err != 0) & even
    toward = torch.where(err > 0, _INF, -_INF)
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 with XLA's conversion semantics: truncate toward
    zero, saturate out-of-range values, NaN → 0 (a plain ``.to`` is
    undefined out of range)."""
    big = x >= 2.0 ** 31
    small = x < -(2.0 ** 31)
    safe = torch.where(big | small | torch.isnan(x), 0.0, x)
    out = safe.to(torch.int32)
    out = torch.where(big, 2 ** 31 - 1, out)
    return torch.where(small, -(2 ** 31), out)


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


class FlowBatchView(NamedTuple):
    """Per-event inputs of the fast and general checks (built by the
    engine)."""

    rows: torch.Tensor          # int32[B] main row, >= R padding
    origin_ids: torch.Tensor    # int32[B]
    origin_rows: torch.Tensor   # int32[B] alt-table row, >= RA when absent
    context_ids: torch.Tensor   # int32[B]
    chain_rows: torch.Tensor    # int32[B] alt-table row, >= RA when absent
    acquire: torch.Tensor       # int32[B]
    valid: torch.Tensor         # bool[B]
    cluster_fallback: torch.Tensor  # int32[B] — bit k: check slot-k
    # cluster rule locally (the runtime sends zeros until cluster mode is
    # ported)
    prioritized: Optional[torch.Tensor] = None   # bool[B]; read only by
    # an occupy attempt (enable_occupy and any_prio)


def flow_check(
    table: FlowRuleTable,
    dyn: FlowDynState,
    rule_idx: torch.Tensor,
    spec: WindowSpec,
    main_second: WindowState,
    alt_second: WindowState,
    main_threads: torch.Tensor,
    alt_threads: torch.Tensor,
    batch: FlowBatchView,
    now_idx_s: int,
    rel_now_ms: int,
    minute_spec: Optional[WindowSpec] = None,
    main_minute: Optional[WindowState] = None,
    now_idx_m: Optional[int] = None,
    has_thread_rules: bool = True,
    sortfree: bool = False,
    in_win_ms: Optional[int] = None,
    occupy_timeout_ms: int = 500,
    enable_occupy: bool = False,
    any_prio: bool = False,
) -> Tuple[FlowDynState, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """General-path flow check → (dyn', allow bool[B], wait_ms int32[B],
    occupied bool[B], sf_overflow int32 scalar). ``wait_ms`` > 0 with
    ``allow`` = a rate-limiter pass after that wait, or an occupied pass.
    ``has_thread_rules=False`` skips the thread-gauge reads (nothing loaded
    reads them). ``sortfree`` groups the segments through the claim
    cascade and counting order (:mod:`ops.sortfree`) — bit-identical
    either way; ``sf_overflow`` counts the cascade's elements that took the
    sorted order (zero without ``sortfree``).

    ``enable_occupy`` folds live bookings on main-row selections into the
    QPS base; with ``any_prio`` (the host knows a prioritized lane is in
    the batch) a denied prioritized pair of a DEFAULT QPS rule may book
    the next window (``tryOccupyNext``) when the passes surviving into it
    plus its live bookings leave room and the wait to its edge
    (``win_ms - in_win_ms``) fits ``occupy_timeout_ms``. ``occupied[i]``
    marks an event admitted that way: it waits to the window edge and
    records OCCUPIED_PASS, not PASS.

    Port of ``rules/flow._flow_check_impl``. Segments are (rule, selected
    stat row); each is admitted greedily in batch order
    (:func:`ops.segments.greedy_admit`) and rate limiters pace per rule by
    a fixed point over admitted costs."""
    B = batch.rows.shape[0]
    K = rule_idx.shape[1]
    NF = table.active.shape[0] - 1
    R = rule_idx.shape[0]
    RA = alt_threads.shape[0]
    dev = batch.rows.device
    rep = seg.repeat_each

    rj = seg.padded_table_gather(rule_idx, batch.rows, NF).reshape(-1)
    # ONE packed [NF+1, 9] per-rule gather per index set
    pk = torch.stack([
        table.active.to(torch.int32),          # 0
        table.limit_origin,                    # 1
        table.cluster_mode.to(torch.int32),    # 2
        table.sel_kind,                        # 3
        table.ref_context,                     # 4
        table.ref_row,                         # 5
        table.behavior,                        # 6
        table.grade,                           # 7
        table.max_queue_ms,                    # 8
    ], dim=1)
    g = pk[rj.long()]                                       # [BK, 9]
    act = g[:, 0] != 0

    # --- applicability: limitApp × origin ---
    lim = g[:, 1]
    origin_bk = rep(batch.origin_ids, K)
    ctx_bk = rep(batch.context_ids, K)
    # "other": the origin matches no specific-origin rule of the resource
    specific_hit = ((lim.reshape(B, K) == batch.origin_ids[:, None])
                    & act.reshape(B, K)).any(dim=1)
    app_other = ((lim == LIMIT_OTHER) & ~rep(specific_hit, K)
                 & (origin_bk != 0))
    applicable = act & ((lim == LIMIT_DEFAULT) | (lim == origin_bk)
                        | app_other)
    # cluster-mode rules apply locally only where their fallback bit is set
    slot_bk = torch.arange(K, dtype=torch.int32, device=dev).repeat(B)
    fb_bk = (rep(batch.cluster_fallback, K) >> slot_bk) & 1
    applicable = applicable & ((g[:, 2] == 0) | (fb_bk == 1))
    # CHAIN also needs the event's context to be refResource
    kind = g[:, 3]
    applicable = applicable & ((kind != SEL_CHAIN) | (ctx_bk == g[:, 4]))

    # --- stat-row selection ---
    use_alt = (kind == SEL_ORIGIN) | (kind == SEL_CHAIN)
    sel_main_row = torch.where(kind == SEL_REF, g[:, 5], rep(batch.rows, K))
    sel_alt_row = torch.where(kind == SEL_CHAIN, rep(batch.chain_rows, K),
                              rep(batch.origin_rows, K))
    # an absent alt row (no origin / chain stats): the rule passes
    applicable = applicable & (~use_alt | (sel_alt_row < RA))

    # --- current counts for the selected rows ---
    main_r = torch.clamp(sel_main_row, max=R - 1)
    alt_r = torch.clamp(sel_alt_row, max=RA - 1)
    main_pass = window_sum_rows(spec, main_second, main_r, ev.PASS,
                                now_idx_s).to(torch.float32)
    alt_pass = window_sum_rows(spec, alt_second, alt_r, ev.PASS,
                               now_idx_s).to(torch.float32)
    cur_pass = torch.where(use_alt, alt_pass, main_pass)
    if has_thread_rules:
        cur_thr = torch.where(use_alt, alt_threads[alt_r.long()],
                              main_threads[main_r.long()]).to(torch.float32)
    else:
        cur_thr = torch.zeros_like(cur_pass)

    dyn, eff_limit_rule = _warmup_sync_and_limits(
        table, dyn, spec, main_second, now_idx_s, rel_now_ms,
        minute_spec, main_minute, now_idx_m)
    eff_limit = eff_limit_rule[rj.long()]

    # --- segment keys: (rule, stat row); a rate limiter paces per rule;
    # inapplicable pairs share the sentinel rule NF's one segment ---
    valid_bk = rep(batch.valid, K) & applicable
    rj_seg = torch.where(valid_bk, rj, NF)
    behavior_bk = g[:, 6]
    is_rl_bk = ((behavior_bk == BEHAVIOR_RATE_LIMITER)
                | (behavior_bk == BEHAVIOR_WARM_UP_RATE_LIMITER)) & (
        g[:, 7] == GRADE_QPS)
    row_seg = torch.where(use_alt, sel_alt_row + R, sel_main_row)
    row_seg = torch.where(is_rl_bk | ~valid_bk, 0, row_seg)
    if sortfree:
        plan = sfo.build_pair_plan(rj_seg, row_seg, rj_seg == NF,
                                   sfo.table_bits(B * K))
        order = torch.where(plan.overflow,
                            seg.sort_by_keys(rj_seg, row_seg),
                            sfo.counting_order(plan.bucket,
                                               plan.num_buckets))
        sf_overflow = plan.overflow_count
    else:
        order = seg.sort_by_keys(rj_seg, row_seg)
        sf_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    rj_s = rj_seg[order]
    starts = seg.segment_starts(rj_s, row_seg[order])
    leader = seg.segment_leader_index(starts)
    acq_s = torch.where(valid_bk, rep(batch.acquire, K).to(torch.float32),
                        0.0)[order]
    g_s = pk[rj_s.long()]
    grade_s = g_s[:, 7]
    behavior_s = g_s[:, 6]
    if enable_occupy:
        # bookings are keyed by resource row: only main-row selections
        # see them; landed ones count toward the rolling sum, and those
        # live in the next window are spoken for when occupying more
        occ_cnt, occ_win = dyn.occupied_count, dyn.occupied_window
        safe_occ = torch.clamp(sel_main_row, max=R - 1).long()
        occ_age_bk = now_idx_s - occ_win[safe_occ]               # [BK, S]
        occ_cnt_bk = occ_cnt[safe_occ]
        no_book = use_alt | (sel_main_row >= R)
        landed_bk = torch.where(
            no_book, 0.0, torch.where(
                (occ_age_bk >= 0) & (occ_age_bk < spec.buckets),
                occ_cnt_bk, 0.0).sum(1))
        nextw_bk = torch.where(
            no_book, 0.0, torch.where(
                (occ_age_bk >= -1) & (occ_age_bk < spec.buckets - 1),
                occ_cnt_bk, 0.0).sum(1))
        base_s = torch.where(grade_s == GRADE_QPS,
                             cur_pass[order] + landed_bk[order],
                             cur_thr[order])
    else:
        base_s = torch.where(grade_s == GRADE_QPS, cur_pass[order],
                             cur_thr[order])
    limit_s = eff_limit[order]
    pass_default_s = seg.greedy_admit(base_s, acq_s, limit_s, starts,
                                      leader)

    # --- rate limiter: cost per element round(acquire / count · 1000); a
    # rejected request never advances the pacing clock, so the admitted
    # costs' prefix is a fixed point (3 passes) ---
    raw_count_s = table.count[rj_s.long()]
    cost_s = _f32_to_i32(torch.round(
        acq_s / torch.clamp(raw_count_s, min=1e-9) * 1000.0))
    c_first = seg.segment_broadcast_first(cost_s, leader)
    L0 = dyn.latest_passed_ms[rj_s.long()]
    due = (L0 + c_first - rel_now_ms) <= 0
    base_time = torch.where(due, rel_now_ms - c_first, L0)
    is_rl = ((behavior_s == BEHAVIOR_RATE_LIMITER)
             | (behavior_s == BEHAVIOR_WARM_UP_RATE_LIMITER)) & (
        grade_s == GRADE_QPS)
    pass_rl_s = torch.ones_like(starts)
    maxq_s = g_s[:, 8]
    for _ in range(3):
        excl_cost, _ = seg.segment_prefix_sum(
            torch.where(pass_rl_s, cost_s, 0), starts, leader)
        latest_s = base_time + excl_cost + cost_s
        wait_s = torch.clamp(latest_s - rel_now_ms, min=0)
        pass_rl_s = (wait_s <= maxq_s) & (raw_count_s > 0)

    applied_s = rj_s != NF
    occ_admit_s = torch.zeros_like(pass_default_s)
    wait_next = 0
    if enable_occupy and in_win_ms is not None and occupy_timeout_ms > 0:
        wait_next = spec.win_ms - in_win_ms
        if any_prio:
            occ_admit_s = _occupy_attempt_general(
                dyn, spec, main_second, batch, sel_main_row, use_alt, order,
                starts, leader, grade_s, behavior_s, is_rl, pass_rl_s,
                pass_default_s, applied_s, acq_s, limit_s, nextw_bk,
                now_idx_s, wait_next <= occupy_timeout_ms, K)
    pair_pass_s = torch.where(is_rl, pass_rl_s,
                              pass_default_s | occ_admit_s) | ~applied_s
    paced_s = is_rl & applied_s
    pair_wait_s = torch.where(paced_s & pair_pass_s, wait_s, 0)
    if enable_occupy:
        pair_wait_s = torch.maximum(
            pair_wait_s, torch.where(occ_admit_s, wait_next, 0).to(
                pair_wait_s.dtype))
    # pacing clocks: the last passing element's latest per rule
    new_latest = torch.where(paced_s & pair_pass_s, latest_s, -(2 ** 30))
    dyn = dyn._replace(latest_passed_ms=seg.scatter_reduce_drop(
        dyn.latest_passed_ms, rj_s, new_latest.to(torch.int32), paced_s,
        "amax"))

    # --- back to events ---
    allow = seg.unsort(order, pair_pass_s).reshape(B, K).all(dim=1)
    wait_ms = seg.unsort(order, pair_wait_s).reshape(B, K).max(dim=1).values
    occupied = (seg.unsort(order, occ_admit_s).reshape(B, K).any(dim=1)
                & allow & batch.valid)
    allow = allow | ~batch.valid
    return dyn, allow, wait_ms.to(torch.int32), occupied, sf_overflow


def _occupy_attempt_general(dyn, spec, main_second, batch, sel_main_row,
                            use_alt, order, starts, leader, grade_s,
                            behavior_s, is_rl, pass_rl_s, pass_default_s,
                            applied_s, acq_s, limit_s, nextw_bk, now_idx_s,
                            can_time: bool, K: int) -> torch.Tensor:
    """:func:`flow_check`'s ``tryOccupyNext`` attempt → the admitted
    pairs' mask (sorted order); commits one booking per admitted event
    into ``dyn``'s ring in place (:func:`_book_next_window`)."""
    B = batch.rows.shape[0]
    R = dyn.occupied_count.shape[0]
    # passes that SURVIVE into window now+1: buckets stamped within the
    # last B-1 windows (the oldest live bucket expires at the edge)
    safe_main = torch.clamp(sel_main_row, max=R - 1).long()
    sdelta = now_idx_s - main_second.stamps[safe_main]       # [BK, B]
    survive = (sdelta >= 0) & (sdelta <= spec.buckets - 2)
    surviving_bk = torch.where(
        survive, main_second.counters[safe_main, :, ev.PASS], 0).sum(
        1, dtype=torch.int32).to(torch.float32)
    prio_s = seg.repeat_each(batch.prioritized, K)[order]
    eligible_s = (prio_s & (grade_s == GRADE_QPS)
                  & (behavior_s == BEHAVIOR_DEFAULT) & ~pass_default_s
                  & applied_s & ~use_alt[order] & can_time)
    occ_base_s = surviving_bk[order] + nextw_bk[order]
    occ_amt_s = torch.where(eligible_s, acq_s, 0.0)
    occ_adm = seg.greedy_admit(occ_base_s, occ_amt_s, limit_s, starts,
                               leader) & eligible_s
    # event-level gate BEFORE committing: every failing pair of the event
    # must itself be occupy-admitted (PriorityWait is the admission)
    pair_ok = torch.where(is_rl, pass_rl_s, pass_default_s | occ_adm) \
        | ~applied_s
    event_ok = seg.unsort(order, pair_ok).reshape(B, K).all(dim=1)
    event_occ = (seg.unsort(order, occ_adm).reshape(B, K).any(dim=1)
                 & event_ok & batch.valid)
    _book_next_window(dyn, event_occ, batch.rows, batch.acquire, now_idx_s)
    return occ_adm & seg.repeat_each(event_occ, K)[order]


def _book_next_window(dyn: FlowDynState, event_occ: torch.Tensor,
                      rows: torch.Tensor, acquire: torch.Tensor,
                      now_idx_s: int) -> None:
    """Book ONE grant per occupy-admitted event on its resource row into
    ring slot ``(now+1) % S`` (the reference's first denying rule throws
    PriorityWait and books on the node once), in place. The grants are a
    float32 scatter-add of ``acquire`` through the kernel seam; lanes not
    admitted point one past the table and drop."""
    occ_cnt, occ_win = dyn.occupied_count, dyn.occupied_window
    R, S = occ_cnt.shape
    nxt = wrap_i32(now_idx_s + 1)
    slot = nxt % S
    grants = torch.zeros((R, 1), dtype=torch.float32, device=rows.device)
    sa.scatter_add(grants, torch.where(event_occ, rows, R), None,
                   torch.where(event_occ, acquire, 0)[:, None])
    grants = grants[:, 0]
    granted = grants > 0
    cnt_s, win_s = occ_cnt[:, slot], occ_win[:, slot]
    keep = win_s == nxt
    new_cnt = torch.where(granted, torch.where(keep, cnt_s, 0.0) + grants,
                          cnt_s)
    win_s.copy_(torch.where(granted, nxt, win_s))
    cnt_s.copy_(new_cnt)


def flow_check_fast(
    table: FlowRuleTable,
    dyn: FlowDynState,
    rule_idx: torch.Tensor,
    spec: WindowSpec,
    main_second: WindowState,
    alt_second: WindowState,
    main_threads: torch.Tensor,
    alt_threads: torch.Tensor,
    batch: FlowBatchView,
    now_idx_s: int,
    rel_now_ms: int,
    minute_spec: Optional[WindowSpec] = None,
    main_minute: Optional[WindowState] = None,
    now_idx_m: Optional[int] = None,
    has_rate_limiter: bool = True,
    has_thread_rules: bool = True,
    rules_bk: Optional[torch.Tensor] = None,
    sortfree: bool = False,
    in_win_ms: Optional[int] = None,
    occupy_timeout_ms: int = 500,
    enable_occupy: bool = False,
    any_prio: bool = False,
) -> Tuple[FlowDynState, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Fast general-path flow check → (dyn', allow bool[B], wait_ms
    int32[B], occupied bool[B], sf_overflow int32 scalar): per-pair
    applicability and stat-row selection live (origins, alt rows, CHAIN
    contexts, RELATE), admission by rank closed forms over ONE composite
    key ``rule · (RA + 1) + (alt row + 1 | 0)``. The HOST verifies
    ``acquire`` uniform over valid events (>= 1) and that the key fits
    int32 (``(NF+1)·(RA+1) < 2^31``); under them it is bit-exact with
    :func:`flow_check` (the JAX package's ``flow_check_fast`` and
    ``flow_check_fast_occupy`` docstrings have the argument). ``sortfree``,
    ``sf_overflow`` and the occupy arguments as in :func:`flow_check`.

    With ``enable_occupy`` landed bookings fold into the per-rule base (a
    valid main-row pair's selected row is its rule's ``sync_row``); the
    occupy attempt (``any_prio``) ranks the ELIGIBLE pairs alone — with a
    uniform acquire the general path's greedy fixed point over them is
    that rank prefix — and its claim overflow adds to ``sf_overflow``.

    Port of ``rules/flow._flow_check_fast_impl`` (``flow_check_fast`` and
    ``flow_check_fast_occupy``, each sort-free or not)."""
    B = batch.rows.shape[0]
    K = rule_idx.shape[1]
    NF = table.active.shape[0] - 1
    R = rule_idx.shape[0]
    RA = alt_threads.shape[0]
    dev = batch.rows.device
    if (NF + 1) * (RA + 1) >= 2 ** 31:
        raise ValueError("rule capacity x alt rows too large for the fast "
                         "path's int32 key")
    if rules_bk is None:
        rules_bk = seg.padded_table_gather(rule_idx, batch.rows, NF)

    # ---- per-rule step state ----
    dyn, eff_limit = _warmup_sync_and_limits(
        table, dyn, spec, main_second, now_idx_s, rel_now_ms,
        minute_spec, main_minute, now_idx_m)
    acq_of_rule = torch.where(batch.valid, batch.acquire, 0).max().to(
        torch.float32)
    if has_rate_limiter:
        is_rl_rule = (((table.behavior == BEHAVIOR_RATE_LIMITER)
                       | (table.behavior == BEHAVIOR_WARM_UP_RATE_LIMITER))
                      & (table.grade == GRADE_QPS))
        base_time, cost, max_k = _rl_closed_form(
            table, dyn, acq_of_rule, rel_now_ms)

    # ---- stat reads: MAIN/REF rows are per rule (the rule's sync_row);
    # ORIGIN/CHAIN rows per event, from the small alt table summed densely
    # once (padding rows read the appended 0) ----
    zero = torch.zeros((1,), dtype=torch.float32, device=dev)
    alt_pass_dense = torch.cat([window_sum_all(
        spec, alt_second, ev.PASS, now_idx_s).to(torch.float32), zero])
    orow = torch.clamp(batch.origin_rows, max=RA).long()
    crow = torch.clamp(batch.chain_rows, max=RA).long()
    or_pass, cr_pass = alt_pass_dense[orow], alt_pass_dense[crow]
    if has_thread_rules:
        alt_thr_dense = torch.cat([alt_threads.to(torch.float32), zero])
        or_thr, cr_thr = alt_thr_dense[orow], alt_thr_dense[crow]
    srow_sel = torch.clamp(table.sync_row, max=R - 1)
    row_pass = window_sum_rows(spec, main_second, srow_sel, ev.PASS,
                               now_idx_s).to(torch.float32)
    if enable_occupy:
        row_pass = row_pass + _landed_per_rule(dyn, srow_sel, spec,
                                               now_idx_s)

    # ---- ONE packed per-rule gather [NF+1, C] → [B, K, C] ----
    cols = [table.active.to(torch.int32),                    # 0
            table.limit_origin,                              # 1
            table.cluster_mode.to(torch.int32),              # 2
            table.sel_kind,                                  # 3
            table.ref_context,                               # 4
            eff_limit.view(torch.int32),                     # 5
            row_pass.view(torch.int32)]                      # 6
    ncol = 7
    if has_rate_limiter:
        i_rl, i_bt, i_cost, i_mk = ncol, ncol + 1, ncol + 2, ncol + 3
        cols += [is_rl_rule.to(torch.int32), base_time, cost, max_k]
        ncol += 4
    if has_thread_rules:
        i_thr, i_grade = ncol, ncol + 1
        row_thr = main_threads[srow_sel.long()].to(torch.float32)
        cols += [row_thr.view(torch.int32), table.grade]
        ncol += 2
    if enable_occupy:
        # only DefaultController-grade rules (QPS, DEFAULT behaviour) have
        # a prioritized path
        i_occ = ncol
        cols += [((table.grade == GRADE_QPS)
                  & (table.behavior == BEHAVIOR_DEFAULT)).to(torch.int32)]
    g = torch.stack(cols, dim=1)[rules_bk.long()]            # [B, K, C]

    def f32(col):
        return g[..., col].contiguous().view(torch.float32)

    # ---- applicability ----
    act = g[..., 0] != 0
    lim = g[..., 1]
    oid = batch.origin_ids[:, None]
    specific_hit = ((lim == oid) & act).any(dim=1, keepdim=True)
    app = act & ((lim == LIMIT_DEFAULT) | (lim == oid)
                 | ((lim == LIMIT_OTHER) & ~specific_hit & (oid != 0)))
    slot_k = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    fb = (batch.cluster_fallback[:, None] >> slot_k) & 1
    app = app & ((g[..., 2] == 0) | (fb == 1))
    kind = g[..., 3]
    app = app & ((kind != SEL_CHAIN)
                 | (batch.context_ids[:, None] == g[..., 4]))
    use_alt = (kind == SEL_ORIGIN) | (kind == SEL_CHAIN)
    is_chain = kind == SEL_CHAIN
    alt_row = torch.where(is_chain, batch.chain_rows[:, None],
                          batch.origin_rows[:, None])
    app = app & (~use_alt | (alt_row < RA))
    valid_pair = batch.valid[:, None] & app

    # ---- per-pair base: the selected stat row's count ----
    cur_pass = torch.where(use_alt, torch.where(is_chain, cr_pass[:, None],
                                                or_pass[:, None]), f32(6))
    if has_thread_rules:
        cur_thr = torch.where(use_alt, torch.where(
            is_chain, cr_thr[:, None], or_thr[:, None]), f32(i_thr))
        base = torch.where(g[..., i_grade] == GRADE_QPS, cur_pass, cur_thr)
    else:
        base = cur_pass

    # ---- composite-key arrival ranks (the only cross-event pass) ----
    if has_rate_limiter:
        rl_p = g[..., i_rl] != 0
        subrow = torch.where(use_alt & ~rl_p, alt_row + 1, 0)
    else:
        subrow = torch.where(use_alt, alt_row + 1, 0)
    sentinel = NF * (RA + 1)
    key = torch.where(valid_pair, rules_bk * (RA + 1) + subrow, sentinel)
    if sortfree:
        rank_h, sf_ovf = sfo.ranks2d_hashed(key, sentinel,
                                            sfo.table_bits(B))
        rank = torch.where(sf_ovf > 0, seg.ranks_per_slot(key), rank_h)
    else:
        rank = seg.ranks_per_slot(key)
        sf_ovf = torch.zeros((), dtype=torch.int32, device=dev)

    # ---- admission (closed forms) ----
    a_f = acq_of_rule
    limit_pair = f32(5)
    pass_default = (base + rank.to(torch.float32) * a_f) + a_f <= limit_pair
    pass_rl = None
    if has_rate_limiter:
        mk = g[..., i_mk]
        pass_rl = rank < mk
        wait_pair = torch.clamp(
            g[..., i_bt] + (torch.minimum(rank, mk) + 1) * g[..., i_cost]
            - rel_now_ms, min=0)

    # ---- occupy attempt (tryOccupyNext) ----
    occ_adm_p = torch.zeros_like(pass_default)
    wait_next = 0
    if enable_occupy and in_win_ms is not None and occupy_timeout_ms > 0:
        wait_next = spec.win_ms - in_win_ms
        if any_prio:
            occ_adm_p, ovf_occ = _occupy_attempt_fast(
                dyn, spec, main_second, batch, srow_sel, rules_bk,
                g[..., i_occ], pass_default, pass_rl,
                rl_p if has_rate_limiter else None,
                valid_pair, use_alt, key, sentinel, limit_pair, a_f,
                now_idx_s, wait_next <= occupy_timeout_ms, sortfree)
            sf_ovf = sf_ovf + ovf_occ

    if has_rate_limiter:
        pair_pass = (torch.where(rl_p, pass_rl, pass_default | occ_adm_p)
                     | ~valid_pair)
        pair_wait = torch.where(rl_p & pair_pass & valid_pair, wait_pair, 0)
        if enable_occupy:
            pair_wait = torch.maximum(pair_wait, torch.where(
                occ_adm_p, wait_next, 0).to(pair_wait.dtype))
        wait_ms = pair_wait.max(dim=1).values
    else:
        pair_pass = (pass_default | occ_adm_p) | ~valid_pair
        wait_ms = (torch.where(occ_adm_p, wait_next, 0).max(dim=1).values
                   if enable_occupy else
                   torch.zeros((B,), dtype=torch.int32, device=dev))
    allow = pair_pass.all(dim=1)
    occupied = occ_adm_p.any(dim=1) & allow & batch.valid

    # ---- pacing-clock update (per rule) ----
    if has_rate_limiter:
        rl_valid = (rl_p & valid_pair).reshape(-1)
        npairs = seg.scatter_reduce_drop(
            torch.zeros((NF + 1,), dtype=torch.int32, device=dev),
            rules_bk.reshape(-1), (rank + 1).reshape(-1), rl_valid, "amax")
        passed = torch.minimum(npairs, max_k)
        passed = torch.where(is_rl_rule & (table.count > 0), passed, 0)
        new_latest = torch.where(passed > 0, base_time + passed * cost,
                                 dyn.latest_passed_ms)
        dyn = dyn._replace(latest_passed_ms=torch.maximum(
            dyn.latest_passed_ms, new_latest))

    allow = allow | ~batch.valid
    return dyn, allow, wait_ms.to(torch.int32), occupied, sf_ovf


def _occupy_attempt_fast(dyn, spec, main_second, batch, srow_sel, rules_bk,
                         occ_rule, pass_default, pass_rl, rl_p, valid_pair,
                         use_alt, key, sentinel: int, limit_pair, a_f,
                         now_idx_s: int, can_time: bool, sortfree: bool):
    """:func:`flow_check_fast`'s ``tryOccupyNext`` attempt → (admitted
    pairs bool[B, K], claim overflow int32 scalar); commits one booking
    per admitted event into ``dyn``'s ring in place."""
    B = batch.rows.shape[0]
    occ_cnt, occ_win = dyn.occupied_count, dyn.occupied_window
    # per rule: passes surviving into window now+1 over its selected row,
    # plus bookings still live in the next window
    srow = srow_sel.long()
    sdelta = now_idx_s - main_second.stamps[srow]            # [NF+1, B]
    survive = (sdelta >= 0) & (sdelta <= spec.buckets - 2)
    surviving = torch.where(
        survive, main_second.counters[srow, :, ev.PASS], 0).sum(
        1, dtype=torch.int32).to(torch.float32)
    occ_age = now_idx_s - occ_win[srow]                      # [NF+1, S]
    nextw = torch.where((occ_age >= -1) & (occ_age < spec.buckets - 1),
                        occ_cnt[srow], 0.0).sum(1)
    occ_base_p = (surviving + nextw)[rules_bk.long()]        # [B, K]
    eligible = (batch.prioritized[:, None] & (occ_rule != 0)
                & ~pass_default & valid_pair & ~use_alt & can_time)
    # ranks among ELIGIBLE pairs only: the general path's greedy fixed
    # point gives the others zero amounts
    key_occ = torch.where(eligible, key, sentinel)
    if sortfree:
        r_occ_h, ovf_occ = sfo.ranks2d_hashed(key_occ, sentinel,
                                              sfo.table_bits(B))
        rank_occ = torch.where(ovf_occ > 0, seg.ranks_per_slot(key_occ),
                               r_occ_h)
    else:
        rank_occ = seg.ranks_per_slot(key_occ)
        ovf_occ = torch.zeros((), dtype=torch.int32, device=key.device)
    occ_adm = (((occ_base_p + rank_occ.to(torch.float32) * a_f) + a_f
                <= limit_pair) & eligible)
    # event-level gate before committing: every failing pair of the event
    # must itself be occupy-admitted
    if rl_p is not None:
        pair_ok = (torch.where(rl_p, pass_rl, pass_default | occ_adm)
                   | ~valid_pair)
    else:
        pair_ok = (pass_default | occ_adm) | ~valid_pair
    event_occ = occ_adm.any(dim=1) & pair_ok.all(dim=1) & batch.valid
    _book_next_window(dyn, event_occ, batch.rows, batch.acquire, now_idx_s)
    return occ_adm & event_occ[:, None], ovf_occ


def flow_check_scalar(
    table: FlowRuleTable,
    dyn: FlowDynState,
    rule_idx: torch.Tensor,
    spec: WindowSpec,
    main_second: WindowState,
    main_threads: torch.Tensor,
    rows: torch.Tensor,           # int32[B] (>= R padding)
    acquire: torch.Tensor,        # int32[B] — HOST-VERIFIED uniform (>= 1)
    valid: torch.Tensor,          # bool[B]
    now_idx_s: int,
    rel_now_ms: int,
    minute_spec: Optional[WindowSpec] = None,
    main_minute: Optional[WindowState] = None,
    now_idx_m: Optional[int] = None,
    has_rate_limiter: bool = True,
    rules_bk: Optional[torch.Tensor] = None,
    occupy_base: bool = False,
) -> Tuple[FlowDynState, torch.Tensor, torch.Tensor]:
    """Scalar-path flow check → (dyn', allow bool[B], wait_ms int32[B]).

    Preconditions the HOST verifies (``runtime.decide_raw_nowait``): no
    origins and no origin/chain rows in the batch, no prioritized events,
    no cluster-fallback bits, ``acquire`` uniform over valid events and
    >= 1. Under them every per-pair quantity is a function of the RULE
    alone, so the check computes [NF+1]-sized admission budgets and
    touches the (event × slot) pair axis only for the rule gather, the
    per-slot arrival ranks, one packed budget gather and compares: a pair
    with arrival rank r passes iff ``(base + r*a) + a <= limit`` (DEFAULT,
    WARM_UP) or ``r < max_k`` (rate limiter closed form).
    ``has_rate_limiter=False`` elides the rate-limiter columns — only
    when the ruleset has no RL/WU-RL rule. ``rules_bk`` is the
    pre-gathered [B, K] rule id table (the pipeline's joint gather).
    ``occupy_base`` folds LANDED occupy bookings into the QPS base.
    """
    B = rows.shape[0]
    K = rule_idx.shape[1]
    NF = table.active.shape[0] - 1
    R = rule_idx.shape[0]

    # ---- per-rule admission state ([NF+1]-sized) ----
    dyn, eff_limit = _warmup_sync_and_limits(
        table, dyn, spec, main_second, now_idx_s, rel_now_ms,
        minute_spec, main_minute, now_idx_m)
    sel_row = torch.clamp(table.sync_row, max=R - 1)
    base_pass = window_sum_rows(spec, main_second, sel_row, ev.PASS,
                                now_idx_s).to(torch.float32)
    if occupy_base:
        base_pass = base_pass + _landed_per_rule(dyn, sel_row, spec,
                                                 now_idx_s)
    base_thr = main_threads[sel_row.long()].to(torch.float32)
    base = torch.where(table.grade == GRADE_QPS, base_pass, base_thr)

    # rules that can apply to an origin-less, fallback-free batch
    applies = (table.active
               & (table.limit_origin == LIMIT_DEFAULT)
               & (~table.cluster_mode)
               & ((table.sel_kind == SEL_MAIN)
                  | (table.sel_kind == SEL_REF)))
    acq_of_rule = torch.where(valid, acquire, 0).max().to(torch.float32)
    if has_rate_limiter:
        is_rl = (((table.behavior == BEHAVIOR_RATE_LIMITER)
                  | (table.behavior == BEHAVIOR_WARM_UP_RATE_LIMITER))
                 & (table.grade == GRADE_QPS))
        base_time, cost, max_k = _rl_closed_form(
            table, dyn, acq_of_rule, rel_now_ms)

    # ---- per-pair work ----
    if rules_bk is None:
        rules_bk = seg.padded_table_gather(rule_idx, rows, NF)
    rj = rules_bk.reshape(-1)                                # [BK]
    valid_bk = seg.repeat_each(valid, K)
    key = torch.where(valid_bk, rj, NF)
    rank = sfo.ranks2d_ident(key.reshape(B, K), NF + 2).reshape(-1)

    a_bk = seg.repeat_each(acquire, K).to(torch.float32)
    limit_eff = torch.where(applies, eff_limit, 3e38)
    cols = [base.view(torch.int32), limit_eff.view(torch.int32)]
    if has_rate_limiter:
        cols += [(is_rl & applies).to(torch.int32), base_time, cost, max_k]
    vt = torch.stack(cols, dim=1)
    g = vt[key.long()]                                       # [BK, C]
    base_pair = g[:, 0].contiguous().view(torch.float32)
    limit_pair = g[:, 1].contiguous().view(torch.float32)
    rankf = rank.to(torch.float32)

    pass_default = (base_pair + rankf * a_bk) + a_bk <= limit_pair
    if has_rate_limiter:
        pass_rl = rank < g[:, 5]
        safe_rank = torch.minimum(rank, g[:, 5])
        wait_pair = torch.clamp(
            g[:, 3] + (safe_rank + 1) * g[:, 4] - rel_now_ms, min=0)
        pair_is_rl = g[:, 2] != 0
        pair_pass = torch.where(pair_is_rl, pass_rl, pass_default)
        pair_pass = pair_pass | (key == NF)
        pair_wait = torch.where(pair_is_rl & pair_pass & (key != NF),
                                wait_pair, 0)
        wait_ms = pair_wait.reshape(B, K).max(dim=1).values
    else:
        pair_pass = pass_default | (key == NF)
        wait_ms = torch.zeros((B,), dtype=torch.int32, device=rows.device)

    allow = pair_pass.reshape(B, K).all(dim=1)

    # ---- pacing-clock update (only when the ruleset has RL rules) ----
    if has_rate_limiter:
        npairs = torch.zeros((NF + 2,), dtype=torch.int32,
                             device=rows.device).scatter_reduce_(
            0, key.long(), rank + 1, reduce="amax")[:NF + 1]
        passed = torch.minimum(npairs, max_k)
        passed = torch.where(is_rl & applies & (table.count > 0), passed, 0)
        new_latest = torch.where(passed > 0, base_time + passed * cost,
                                 dyn.latest_passed_ms)
        dyn = dyn._replace(
            latest_passed_ms=torch.maximum(dyn.latest_passed_ms, new_latest))

    allow = allow | ~valid
    return dyn, allow, wait_ms.to(torch.int32)


def _landed_per_rule(dyn: FlowDynState, sel_row: torch.Tensor,
                     spec: WindowSpec, now_idx_s: int) -> torch.Tensor:
    """LANDED occupy bookings per rule → float32[NF+1]: bookings on the
    rule's selected main row whose target window has been reached and is
    still inside the rolling interval (age in [0, B))."""
    r = sel_row.long()
    occ_age = now_idx_s - dyn.occupied_window[r]             # [NF+1, S]
    return torch.where((occ_age >= 0) & (occ_age < spec.buckets),
                       dyn.occupied_count[r], 0.0).sum(1)


def _rl_closed_form(table: FlowRuleTable, dyn: FlowDynState,
                    acq_of_rule: torch.Tensor, rel_now_ms: int):
    """Per-rule RATE_LIMITER closed form → (base_time, cost, max_k).

    The admitted-rank budget ``max_k = (now + maxq - base_time) // cost``
    has a bounded numerator, so no rank*cost product can overflow int32 —
    a pair passes iff ``rank < max_k``. ``cost == 0`` (huge count): every
    rank shares one wait. ``count <= 0`` blocks everything
    (RateLimiterController.java:30-90)."""
    count_safe = torch.clamp(table.count, min=1e-9)
    cost = _f32_to_i32(torch.round(acq_of_rule / count_safe * 1000.0))
    L0 = dyn.latest_passed_ms
    due = (L0 + cost - rel_now_ms) <= 0
    base_time = torch.where(due, rel_now_ms - cost, L0)
    maxq_eff = torch.where(table.count > 0, table.max_queue_ms, -1)
    rl_numer = rel_now_ms + maxq_eff - base_time
    max_k = torch.clamp(_floordiv(rl_numer, torch.clamp(cost, min=1)), min=0)
    wait0_ok = torch.clamp(base_time - rel_now_ms, min=0) <= maxq_eff
    max_k = torch.where(cost > 0, max_k,
                        torch.where(wait0_ok, 2 ** 30, 0))
    max_k = torch.where(table.count > 0, max_k, 0).to(torch.int32)
    return base_time, cost, max_k


def _warmup_sync_and_limits(
    table: FlowRuleTable, dyn: FlowDynState, spec: WindowSpec,
    main_second: WindowState, now_idx_s: int, rel_now_ms: int,
    minute_spec: Optional[WindowSpec], main_minute: Optional[WindowState],
    now_idx_m: Optional[int],
) -> Tuple[FlowDynState, torch.Tensor]:
    """Once-per-step warm-up token refill (WarmUpController.syncToken) and
    the per-rule effective QPS limit for this step. Token state syncs
    against the rule's ``sync_row`` using the previous second's pass
    count (the minute window's previous bucket when the minute window is
    on, else the second window's previous sub-second bucket)."""
    is_wu = ((table.behavior == BEHAVIOR_WARM_UP)
             | (table.behavior == BEHAVIOR_WARM_UP_RATE_LIMITER)) & (
        table.grade == GRADE_QPS)
    R = main_second.stamps.shape[0]
    srow = torch.clamp(table.sync_row, max=R - 1)
    if minute_spec is not None and main_minute is not None:
        pass_prev = prev_window_sum_rows(minute_spec, main_minute, srow,
                                         ev.PASS, now_idx_m).to(torch.float32)
    else:
        pass_prev = prev_window_sum_rows(spec, main_second, srow, ev.PASS,
                                         now_idx_s).to(torch.float32)

    now_sec = rel_now_ms // 1000
    should_sync = is_wu & (now_sec > dyn.last_filled_sec)
    old = dyn.stored_tokens
    elapsed_s = (now_sec - dyn.last_filled_sec).to(torch.float32)
    refill_ok = (old < table.warning_token) | (
        (old > table.warning_token)
        & (pass_prev < table.count / torch.clamp(table.cold_factor,
                                                 min=1.001)))
    refilled = torch.minimum(_fma_f32(elapsed_s, table.count, old),
                             table.max_token)
    new_tokens = torch.where(refill_ok, refilled, old)
    new_tokens = torch.clamp(new_tokens - pass_prev, min=0.0)
    stored = torch.where(should_sync, new_tokens, old)
    last_filled = torch.where(should_sync, now_sec, dyn.last_filled_sec)
    dyn = dyn._replace(stored_tokens=stored, last_filled_sec=last_filled)

    above = torch.clamp(stored - table.warning_token, min=0.0)
    warning_qps = 1.0 / _fma_f32(above, table.slope,
                                 1.0 / torch.clamp(table.count, min=1e-9))
    eff = torch.where(is_wu & (stored >= table.warning_token),
                      warning_qps, table.count)
    return dyn, eff
