"""The least time the counter scatter-adds of a step could take, from the
step's inputs alone.

The device's peak memory rate is the H100 SXM's published 3.35 TB/s
(at its 700 W limit). A scatter-add of ``n`` updates reads each update
once (its index and amounts, ``bytes_per_lane``) and reads and writes
once each distinct 32-byte sector that a nonzero update lands in
(``chip_smoke._bound_ms``'s arithmetic). The updates are those the
serving step's inputs need, whatever implements them: a decided event
counts PASS or BLOCK into its row's current bucket of the second and
the minute window; a completion counts SUCCESS (and EXCEPTION) and adds
its RT into the same buckets, lands in its row's RT histogram bucket,
and counts into its breaker's window (total, and bad when it raised).
An event or a completion with an origin or a context node does the
same to each of its nodes' second window (no histogram, no breaker);
where the configuration keeps thread gauges, an admitted event adds one
to its row's and its nodes' gauges and a completion takes one off.
Tables are laid out row-major: counters ``int32[R, B, 8]``, RT sums
``float32[R, B]``, the histogram ``int32[R, 32]``, gauges ``int32[R]``,
breaker counts ``int32[rules + 1]``.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
SECTOR = 32
EVENTS = 8
PASS, BLOCK, EXCEPTION, SUCCESS = 0, 1, 2, 3
HIST_BUCKETS = 32


def bound_s(updates) -> float:
    """``updates``: ``(lanes, bytes_per_lane, byte addresses of the
    nonzero updates)`` of each scatter-add → least seconds."""
    stream = 0
    sectors = 0
    for lanes, per_lane, addr in updates:
        stream += lanes * per_lane
        sectors += int(torch.unique(torch.div(
            addr, SECTOR, rounding_mode="floor")).numel())
    return (stream + 2 * SECTOR * sectors) / HBM_BYTES_PER_S


def window_cells(rows, events, bucket: int, buckets: int):
    """Byte addresses of ``(row, bucket, event)`` in ``int32[R, B, 8]``."""
    return ((rows * buckets + bucket) * EVENTS + events) * 4


def window_updates(rows, events, exit_rows, exit_rt, exit_err, k: int,
                   b: int) -> list:
    """The updates of one window: a record per decided event, and per
    completion its counts and its RT."""
    out = [(rows.shape[0], 12, window_cells(rows, events, k, b))]
    m = exit_rows.shape[0]
    if m:
        cells = torch.cat([
            window_cells(exit_rows, torch.full_like(exit_rows, SUCCESS),
                         k, b),
            window_cells(exit_rows[exit_err],
                         torch.full_like(exit_rows[exit_err], EXCEPTION),
                         k, b)])
        out.append((m, 12, cells))
        live = exit_rt != 0
        out.append((m, 8, (exit_rows[live] * b + k) * 4))
    return out


def gauge_updates(rows, allow, exit_rows) -> list:
    """+1 a gauge per admitted event, -1 per completion."""
    return [(int(allow.sum()), 8, rows[allow] * 4),
            (exit_rows.shape[0], 8, exit_rows * 4)]


def fused_step_updates(rows, allow, exit_rows, exit_rt, exit_err,
                       exit_breaker, windows, nodes=None, exit_nodes=None,
                       node_window=None, gauges: bool = False) -> list:
    """The scatter-adds of one fused step. ``rows`` the batch's rows,
    ``allow`` its verdicts, ``exit_*`` the completions' rows, RT (ms),
    raised flag and breaker rule (-1 for none), all int64/bool tensors;
    ``windows`` ``[(bucket, buckets)]`` of the resource table's second
    and minute windows. ``nodes`` / ``exit_nodes`` (event, node) index
    pairs into the events / completions and their node rows, with
    ``node_window`` the node table's ``(bucket, buckets)``; ``gauges``
    whether thread gauges are kept."""
    out = []
    ev = torch.where(allow, PASS, BLOCK)
    for k, b in windows:
        out += window_updates(rows, ev, exit_rows, exit_rt, exit_err, k, b)
    m = exit_rows.shape[0]
    if m:
        edges = torch.pow(2, torch.arange(HIST_BUCKETS - 1,
                                          device=exit_rt.device))
        hb = (exit_rt[:, None] > edges).sum(1)
        out.append((m, 12, (exit_rows * HIST_BUCKETS + hb) * 4))
        ruled = exit_breaker >= 0
        out.append((int(ruled.sum()), 8, exit_breaker[ruled] * 4))
        bad = ruled & exit_err
        out.append((int(bad.sum()), 8, exit_breaker[bad] * 4))
    if gauges:
        out += gauge_updates(rows, allow, exit_rows)
    if nodes is not None:
        (ei, node), (xi, xnode) = nodes, exit_nodes
        k, b = node_window
        out += window_updates(node, ev[ei], xnode, exit_rt[xi], exit_err[xi],
                              k, b)
        if gauges:
            out += gauge_updates(node, allow[ei], xnode)
    return out
