"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, on the same inputs.

Windows are compared by what they hold, not by how they hold it: for
each of the window's live indices (the newest ``buckets``), a row's
bucket of that index if its stamp says so, else an empty bucket. So a
program that restamps every row each step and a reference that resets
buckets lazily compare equal when they count the same events.

The numbers (each compared with its limit in ``portbench/checks/
<workload>.json``; a cell compares those its file gives a limit):

* ``verdicts_differ`` — events, over the batches whose verdicts were
  kept, whose ``allow``, ``reason`` or ``wait_ms`` differ;
* ``counters_differ`` — state cells that differ: window counters and RT
  minima (every window), and every other leaf the reference holds (the
  RT histogram, the breakers; the thread gauges and the rules' pacing
  and warm-up state where the reference keeps them);
* ``rt_sum_gap`` — the largest gap of an RT sum cell, as a share of the
  reference's sum (or of 1 ms where that is smaller);
* ``off_route`` — dispatches that did not take the cell's route;
* ``unanswered`` — batches whose verdicts never came.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2 ** 31 - 1


def wrap32(x: int) -> int:
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def window_view(counters, stamps, rt_sum, min_rt, idx: int):
    """``(counters [R, B, E], rt_sum [R, B], min_rt [R, B])`` of the
    window indices ``idx, idx - 1, ...``: empty where a row's bucket
    holds another index."""
    b = stamps.shape[1]
    cs, rs, ms = [], [], []
    for age in range(b):
        w = wrap32(idx - age)
        k = w % b
        live = stamps[:, k].to(torch.int64) == w
        cs.append(torch.where(live[:, None], counters[:, k, :]
                              .to(torch.int64), 0))
        rs.append(torch.where(live, rt_sum[:, k].to(torch.float64), 0.0))
        ms.append(torch.where(live, min_rt[:, k].to(torch.int64),
                              INT32_MAX))
    return torch.stack(cs, 1), torch.stack(rs, 1), torch.stack(ms, 1)


def state_numbers(prog: dict, ref: dict, at_ms: int, windows: dict,
                  device) -> dict:
    """``counters_differ`` and ``rt_sum_gap`` of the final states.
    ``prog`` holds the program's leaves (numpy, by the names of
    ``convert.engine_to_numpy``), ``ref`` the reference's (tensors, by
    the same names); ``windows`` maps a window's name to its bucket
    length in ms. Compared leaf by leaf on ``device``."""
    def dev(a):
        return torch.as_tensor(a).to(device)

    differ = 0
    gap = 0.0
    for tag, win_ms in windows.items():
        idx = wrap32(at_ms // win_ms)
        pv = window_view(*(dev(prog[f"{tag}.{f}"]) for f in
                           ("counters", "stamps", "rt_sum", "min_rt")), idx)
        rv = window_view(*(ref[f"{tag}.{f}"] for f in
                           ("counters", "stamps", "rt_sum", "min_rt")), idx)
        differ += int((pv[0] != rv[0]).sum()) + int((pv[2] != rv[2]).sum())
        scale = torch.clamp(rv[1].abs(), min=1.0)
        gap = max(gap, float(((pv[1] - rv[1]).abs() / scale).max()))
        del pv, rv
    # every other leaf the reference holds: the RT histogram, the thread
    # gauges, the breakers and the pacing and warm-up state of the rules,
    # over the reference's rows or rules (the program's tables may be
    # longer: unused rule slots)
    for name, r in ref.items():
        if name.split(".")[0] in windows:
            continue
        p = dev(prog[name][:r.shape[0]])
        differ += int((p.to(r.dtype) != r).sum())
    return {"counters_differ": differ, "rt_sum_gap": gap}


def verdicts_differ(prog, ref) -> int:
    """Events whose verdict differs: ``prog`` is the program's
    ``Verdicts`` (numpy), ``ref`` the reference's ``(allow, reason,
    wait_ms)`` tensors."""
    allow, reason, wait = (t.cpu().numpy() for t in ref)
    bad = ((np.asarray(prog.allow) != allow)
           | (np.asarray(prog.reason).astype(np.int64)
              != reason.astype(np.int64))
           | (np.asarray(prog.wait_ms).astype(np.int64)
              != wait.astype(np.int64)))
    return int(np.count_nonzero(bad))


def judge(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit at or under it (a limit without a
    number fails)."""
    return all(k in numbers and numbers[k] <= limits[k] for k in limits)
