"""Circuit breakers: DegradeSlot.

Port of ``sentinel_tpu/rules/degrade.py`` (the rule object, the compiler,
:func:`degrade_entry_check`, one function for the JAX package's
``degrade_entry_check`` and ``degrade_entry_check_scalar``, and
:func:`degrade_exit_feed`).
Reference (``sentinel-core/.../slots/block/degrade/``): ``DegradeSlot``,
``AbstractCircuitBreaker`` (CLOSED/OPEN/HALF_OPEN, one probe after
``timeWindow``), ``ResponseTimeCircuitBreaker`` and
``ExceptionCircuitBreaker`` over a single-bucket window per rule.

Where the JAX package branches with ``lax.cond`` (probe election only when
some breaker is OPEN and due; probe resolution only when some breaker is
HALF_OPEN), the port computes the elected branch unconditionally: with no
rule OPEN-and-due (resp. HALF_OPEN) that branch returns exactly the
pass-through values, so the result is identical and no host sync decides
a branch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.ops import scatter_add as sa
from sentinel_tpu_torch.ops import segments as seg

# Grades (reference RuleConstant.DEGRADE_GRADE_*)
GRADE_RT = 0
GRADE_EXCEPTION_RATIO = 1
GRADE_EXCEPTION_COUNT = 2

STATE_CLOSED = 0
STATE_OPEN = 1
STATE_HALF_OPEN = 2


@dataclasses.dataclass
class DegradeRule:
    """Host-facing rule (reference ``DegradeRule.java`` field parity)."""

    resource: str
    grade: int
    count: float                 # RT: max allowed rt ms; RATIO: [0,1]; COUNT: n
    time_window: int             # seconds to stay OPEN
    min_request_amount: int = 5
    stat_interval_ms: int = 1000
    slow_ratio_threshold: float = 1.0

    def is_valid(self) -> bool:
        if not self.resource or self.count < 0 or self.time_window <= 0:
            return False
        if self.grade not in (GRADE_RT, GRADE_EXCEPTION_RATIO, GRADE_EXCEPTION_COUNT):
            return False
        if self.grade == GRADE_EXCEPTION_RATIO and self.count > 1.0:
            return False
        if self.min_request_amount <= 0 or self.stat_interval_ms <= 0:
            return False
        if self.grade == GRADE_RT and not (0.0 <= self.slow_ratio_threshold <= 1.0):
            return False
        return True


class DegradeRuleTable(NamedTuple):
    """Static device arrays, ND+1 rows (sentinel last)."""

    active: torch.Tensor              # bool
    grade: torch.Tensor               # int32
    count: torch.Tensor               # float32
    retry_timeout_ms: torch.Tensor    # int32 (time_window * 1000)
    min_request: torch.Tensor         # int32
    interval_ms: torch.Tensor         # int32
    ratio_threshold: torch.Tensor     # float32 (slow ratio or error ratio or count)


class BreakerState(NamedTuple):
    """Mutable device state."""

    state: torch.Tensor               # int32[ND+1] STATE_*
    next_retry_ms: torch.Tensor       # int32[ND+1] rel-ms
    win_stamp: torch.Tensor           # int32[ND+1] window index of the bucket
    bad: torch.Tensor                 # int32[ND+1] slow or error count
    total: torch.Tensor               # int32[ND+1] completed count


class CompiledDegradeRules(NamedTuple):
    table: DegradeRuleTable
    rule_idx: torch.Tensor            # int32[R, Kd]
    rules: Tuple[DegradeRule, ...]
    num_active: int
    k_used: int = 1                   # max rules on any one resource
    rule_idx_np: Optional[np.ndarray] = None


def init_breaker_state(nd: int, device="cpu") -> BreakerState:
    def full(value):
        return torch.full((nd + 1,), value, dtype=torch.int32, device=device)
    return BreakerState(state=full(0), next_retry_ms=full(-(2 ** 30)),
                        win_stamp=full(-(2 ** 30)), bad=full(0),
                        total=full(0))


def compile_degrade_rules(rules: Sequence[DegradeRule], *, resource_registry,
                          capacity: int, k_per_resource: int,
                          num_rows: int,
                          device="cpu") -> CompiledDegradeRules:
    valid = [r for r in rules if r.is_valid()]
    if len(valid) > capacity:
        raise ValueError(f"too many degrade rules: {len(valid)} > {capacity}")
    nd = capacity
    active = np.zeros(nd + 1, np.bool_)
    grade = np.zeros(nd + 1, np.int32)
    count = np.zeros(nd + 1, np.float32)
    retry = np.full(nd + 1, 1, np.int32)
    minreq = np.full(nd + 1, 1, np.int32)
    interval = np.full(nd + 1, 1000, np.int32)
    ratio = np.zeros(nd + 1, np.float32)
    rule_idx = np.full((num_rows, k_per_resource), nd, np.int32)
    slots_used = {}
    for j, r in enumerate(valid):
        row = resource_registry.pin(r.resource)
        k = slots_used.get(row, 0)
        if k >= k_per_resource:
            raise ValueError(
                f"more than {k_per_resource} degrade rules for {r.resource!r}")
        slots_used[row] = k + 1
        rule_idx[row, k] = j
        active[j] = True
        grade[j] = r.grade
        count[j] = r.count
        retry[j] = r.time_window * 1000
        minreq[j] = r.min_request_amount
        interval[j] = r.stat_interval_ms
        if r.grade == GRADE_RT:
            ratio[j] = r.slow_ratio_threshold
        elif r.grade == GRADE_EXCEPTION_RATIO:
            ratio[j] = r.count
        else:
            ratio[j] = r.count  # absolute error count
    table = DegradeRuleTable(*(
        torch.from_numpy(a).to(device) for a in (
            active, grade, count, retry, minreq, interval, ratio)))
    return CompiledDegradeRules(table=table,
                                rule_idx=torch.from_numpy(rule_idx).to(device),
                                rules=tuple(valid), num_active=len(valid),
                                k_used=max(1, max(slots_used.values(),
                                                  default=0)),
                                rule_idx_np=rule_idx)


def degrade_entry_check(
    table: DegradeRuleTable, st: BreakerState, rule_idx: torch.Tensor,
    rows: torch.Tensor, valid: torch.Tensor, rel_now_ms: int,
    rules_bk: Optional[torch.Tensor] = None,
) -> Tuple[BreakerState, torch.Tensor]:
    """Entry check of every admission path → (state', allow bool[B]).

    CLOSED passes; an OPEN rule whose retry window elapsed passes ONE
    probe — the first valid pair in batch order, the CAS-winner analog —
    and turns HALF_OPEN, but only when that probe's event is admitted by
    every breaker of its resource; HALF_OPEN blocks. ``rules_bk`` is the
    pre-gathered [B, Kd] rule id table (None = gather here). Reference:
    ``AbstractCircuitBreaker.tryPass`` + ``fromOpenToHalfOpen``.

    The JAX package has two forms: ``degrade_entry_check_scalar`` and, for
    the general path, ``degrade_entry_check``, which sorts the (event,
    rule) pairs by rule and lets each OPEN rule's segment-first pair be
    its probe. Breaker state is per rule, so the first valid pair in batch
    order is the same winner (an inactive rule is structurally CLOSED: its
    pairs pass and never win a probe, just as the sorted form routes them
    to the sentinel), and this one function equals both, bit for bit."""
    B = rows.shape[0]
    Kd = rule_idx.shape[1]
    ND = table.active.shape[0] - 1
    BK = B * Kd

    if rules_bk is None:
        rules_bk = seg.padded_table_gather(rule_idx, rows, ND)
    rj = rules_bk.reshape(-1)
    valid_bk = seg.repeat_each(valid, Kd)
    key = torch.where(valid_bk, rj, ND)
    key_l = key.long()

    open_due = ((st.state == STATE_OPEN)
                & ((rel_now_ms - st.next_retry_ms) >= 0)
                & table.active)
    pass_rule = (st.state == STATE_CLOSED) | ~table.active
    # (a view's fill_: an indexed store of a Python scalar would copy it
    # from the host and wait for the stream)
    pass_rule.narrow(0, ND, 1).fill_(True)       # sentinel never blocks
    pair_base = pass_rule[key_l]

    idx = torch.arange(BK, dtype=torch.int32, device=rows.device)
    win = seg.first_index_by_key(key, ND + 1)
    winner_pair = (idx == win[key_l]) & open_due[key_l]
    pair_pass = pair_base | winner_pair
    allow_ev = pair_pass.reshape(B, Kd).all(dim=1)
    winner_ev = torch.clamp(torch.div(win, Kd, rounding_mode="floor"),
                            max=B - 1)
    ok = open_due & (win < BK) & allow_ev[winner_ev.long()]
    new_state = torch.where(ok, STATE_HALF_OPEN, st.state)
    new_state.narrow(0, ND, 1).fill_(STATE_CLOSED)
    return st._replace(state=new_state), allow_ev | ~valid


def degrade_exit_feed(
    table: DegradeRuleTable, st: BreakerState, rule_idx: torch.Tensor,
    rows: torch.Tensor, rt_ms: torch.Tensor, error: torch.Tensor,
    valid: torch.Tensor, rel_now_ms: int,
) -> BreakerState:
    """Completion feed (``DegradeSlot.exit`` → ``onRequestComplete``):
    resolves HALF_OPEN probes (the first valid completion of the rule in
    batch order decides), records (total, slow-or-error) into each rule's
    single bucket with lazy per-rule window reset, and trips CLOSED
    breakers whose window crossed the threshold."""
    Kd = rule_idx.shape[1]
    ND = table.active.shape[0] - 1

    rj = seg.padded_table_gather(rule_idx, rows, ND).reshape(-1)
    valid_bk = seg.repeat_each(valid, Kd) & table.active[rj.long()] & (rj != ND)
    rj_safe = torch.where(valid_bk, rj, ND)
    rs = rj_safe.long()

    rt_bk = seg.repeat_each(rt_ms, Kd)
    err_bk = seg.repeat_each(error, Kd)
    is_rt = table.grade[rs] == GRADE_RT
    bad_bk = torch.where(is_rt, rt_bk.to(torch.float32) > table.count[rs],
                         err_bk).to(torch.int32)

    # --- HALF_OPEN probe resolution (before window bookkeeping) ---
    BK = rj_safe.shape[0]
    win = seg.first_index_by_key(rj_safe, ND + 1)
    half = (st.state == STATE_HALF_OPEN) & (win < BK)
    winner_bad = bad_bk[torch.clamp(win, max=BK - 1).long()]
    ok_r = half & (winner_bad == 0)
    fail_r = half & (winner_bad != 0)
    state = torch.where(ok_r, STATE_CLOSED,
                        torch.where(fail_r, STATE_OPEN, st.state))
    next_retry = torch.where(fail_r, rel_now_ms + table.retry_timeout_ms,
                             st.next_retry_ms)
    # closing resets the stat window (reference resetStat on close)
    win_stamp = torch.where(ok_r, -(2 ** 30), st.win_stamp)
    state.narrow(0, ND, 1).fill_(STATE_CLOSED)

    # --- single-bucket lazy reset + scatter-add ---
    # every pair of a rule computes the same widx/keep, so the duplicate
    # writes below all carry one value (deterministic under index_put_)
    now = torch.full_like(rj_safe, rel_now_ms)
    widx = torch.div(now, torch.clamp(table.interval_ms[rs], min=1),
                     rounding_mode="floor")
    keep = (win_stamp[rs] == widx).to(torch.int32)
    bad = st.bad.clone()
    total = st.total.clone()
    bad.index_put_((rs,), st.bad[rs] * keep)
    total.index_put_((rs,), st.total[rs] * keep)
    win_stamp = win_stamp.index_put_((rs,), widx)
    ones = valid_bk.to(torch.int32)
    # the per-rule counts are int32 scatter-adds: the kernel seam (most
    # pairs are invalid or rule-less, land on the ND sentinel with amount
    # 0, and the kernel skips zero amounts)
    sa.scatter_add(bad[:, None], rj_safe, None, (bad_bk * ones)[:, None])
    sa.scatter_add(total[:, None], rj_safe, None, ones[:, None])

    # --- trip CLOSED breakers (vector over rules) ---
    totals = total.to(torch.float32)
    bads = bad.to(torch.float32)
    enough = total >= table.min_request
    ratio = bads / torch.clamp(totals, min=1.0)
    trip_ratio = enough & (ratio > table.ratio_threshold)
    trip_count = bads >= table.ratio_threshold
    trip = torch.where(table.grade == GRADE_EXCEPTION_COUNT,
                       enough & trip_count, trip_ratio)
    trip = trip & (state == STATE_CLOSED) & table.active
    state = torch.where(trip, STATE_OPEN, state)
    next_retry = torch.where(trip, rel_now_ms + table.retry_timeout_ms,
                             next_retry)
    return BreakerState(state=state.to(torch.int32),
                        next_retry_ms=next_retry.to(torch.int32),
                        win_stamp=win_stamp.to(torch.int32), bad=bad,
                        total=total)
