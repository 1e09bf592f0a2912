"""System adaptive protection (SystemSlot).

Port of ``sentinel_tpu/rules/system.py``. Reference
(``sentinel-core/.../slots/system/SystemRuleManager.java``):
``checkSystem`` gates only ``EntryType.IN`` traffic against *global*
inbound aggregates — total QPS, total thread count, average RT, system
load1 (with the BBR-style escape hatch) and CPU usage. Thresholds are the
minimum over all loaded rules, folded host-side into one scalar struct at
rule load; load and CPU are host-sampled floats fed into the step. The
global inbound aggregate is row 0 of the main tables
(``Constants.ENTRY_NODE``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from sentinel_tpu_torch.core.registry import ENTRY_NODE_ROW
from sentinel_tpu_torch.stats import events as ev
from sentinel_tpu_torch.stats.window import (
    WindowSpec, WindowState, min_rt_rows, valid_mask,
)


@dataclasses.dataclass
class SystemRule:
    """Reference ``SystemRule.java``: any subset of gates; -1 = unset."""

    highest_system_load: float = -1.0
    highest_cpu_usage: float = -1.0
    qps: float = -1.0
    avg_rt: float = -1.0          # ms
    max_thread: float = -1.0


_UNSET = float(2 ** 31)


class SystemThresholds(NamedTuple):
    """Folded minima, each a float32 0-d tensor."""

    max_load: torch.Tensor
    max_cpu: torch.Tensor
    max_qps: torch.Tensor
    max_rt: torch.Tensor
    max_thread: torch.Tensor


def compile_system_rules(rules: Sequence[SystemRule],
                         device="cpu") -> SystemThresholds:
    def fold(vals):
        vals = [v for v in vals if v >= 0.0]
        v = min(vals) if vals else _UNSET
        return torch.tensor(v, dtype=torch.float32, device=device)

    return SystemThresholds(
        max_load=fold([r.highest_system_load for r in rules]),
        max_cpu=fold([r.highest_cpu_usage for r in rules]),
        max_qps=fold([r.qps for r in rules]),
        max_rt=fold([r.avg_rt for r in rules]),
        max_thread=fold([r.max_thread for r in rules]),
    )


def system_check(
    thresholds: SystemThresholds,
    spec: WindowSpec,
    main_second: WindowState,
    main_threads: torch.Tensor,
    is_in: torch.Tensor,        # bool[B] — EntryType.IN events only are gated
    acquire: torch.Tensor,      # int32[B]
    valid: torch.Tensor,        # bool[B]
    now_idx_s: int,
    load1: float,               # host-sampled, float32-representable
    cpu_usage: float,
    statistic_max_rt: int,
) -> torch.Tensor:
    """→ allow bool[B] (False = SystemBlockException)."""
    dev = main_threads.device
    row0 = torch.full((1,), ENTRY_NODE_ROW, dtype=torch.int32, device=dev)
    gated = is_in & valid

    entry = main_second.counters[ENTRY_NODE_ROW]                  # [Bk, E]
    live = valid_mask(spec, main_second.stamps[ENTRY_NODE_ROW], now_idx_s)
    pass_1s = torch.where(live, entry[:, ev.PASS], 0).sum(
        dtype=torch.int32).to(torch.float32)
    succ_1s = torch.where(live, entry[:, ev.SUCCESS], 0).sum(
        dtype=torch.int32).to(torch.float32)
    rt_sum = torch.where(live, main_second.rt_sum[ENTRY_NODE_ROW], 0.0).sum()
    avg_rt = torch.where(succ_1s > 0,
                         rt_sum / torch.clamp(succ_1s, min=1.0), 0.0)
    cur_thread = main_threads[ENTRY_NODE_ROW].to(torch.float32)
    min_rt = min_rt_rows(spec, main_second, row0, now_idx_s,
                         statistic_max_rt)[0].to(torch.float32)
    # maxSuccessQps (StatisticNode): max bucket success × buckets/sec
    per_sec = 1000.0 / spec.win_ms
    max_succ = torch.where(live, entry[:, ev.SUCCESS], 0).max().to(
        torch.float32)
    max_success_qps = max_succ * per_sec

    # greedy in-batch admission for the global QPS gate (a denied request
    # never consumes budget for batch peers) — fixed-point refinement,
    # exact for uniform acquire
    acq = torch.where(gated, acquire, 0).to(torch.float32)
    qps_ok = torch.ones_like(gated)
    for _ in range(3):
        contrib = torch.where(qps_ok, acq, 0.0)
        prefix = torch.cumsum(contrib, 0) - contrib
        qps_ok = pass_1s + prefix + acq <= thresholds.max_qps

    thread_ok = cur_thread <= thresholds.max_thread
    rt_ok = avg_rt <= thresholds.max_rt

    # BBR check (SystemRuleManager.checkBbr)
    bbr_ok = (cur_thread <= 1.0) | (
        cur_thread <= max_success_qps * min_rt / 1000.0)
    # a Python float compares against a float32 tensor in float32
    load_ok = (thresholds.max_load >= load1) | bbr_ok
    cpu_ok = thresholds.max_cpu >= cpu_usage

    ok = qps_ok & thread_ok & rt_ok & load_ok & cpu_ok
    return ok | ~gated
