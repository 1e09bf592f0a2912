"""Plain reference of Sentinel's local flow control and circuit breaking,
with node selection by caller and by entrance: flow rules of every
``limitApp`` (default, a named origin, ``other``), strategy (DIRECT,
RELATE, CHAIN), behaviour (DEFAULT, WARM_UP, RATE_LIMITER) and grade
(QPS, THREAD), the origin and context nodes, the thread gauges,
exception breakers, the second and minute windows and the per-resource
RT histogram; one batch step at a time.

Written from the reference semantics (``FlowRuleChecker.
selectNodeByRequesterAndStrategy``, ``DefaultController``,
``WarmUpController``, ``RateLimiterController``, ``StatisticSlot``), in
plain PyTorch. It imports nothing of the program and takes nothing it
made. Names, origins and contexts get their ids as a registry that
hands out ids in first-seen order does (row 0, origin 0 and context 0
are reserved): first what the rules name, in load order, then the
traffic's names. An origin's node for a resource and a context's node
for a resource live in one table of ``2 · max_resources`` rows at the
row the published hash gives, ``((row · 0x9E3779B1) ^ ((id · 2 + kind)
· 0x85EBCA6B)) mod 2^32 mod rows``, kind 0 for an origin and 1 for a
context (pairs that hash alike share a node).

A batch's flow rules are checked per (event, rule) pair, in arrival
order: a pair applies when the rule's ``limitApp`` is ``default``, is
the event's origin, or is ``other`` and no rule of the resource names
the event's origin; a CHAIN rule applies to events of its context. The
pair reads its node: the resource's (DIRECT default), the origin's
(DIRECT named or other), the related resource's (RELATE), the
context's (CHAIN). DEFAULT, WARM_UP and THREAD admit while the node's
count so far this second (QPS) or its threads (THREAD), plus the
events of this batch admitted before on that rule and node, stay within
the limit; WARM_UP's limit follows its token bucket, synced once a
second from the node's previous second of passes; RATE_LIMITER paces the
rule's admissions ``1000 / count`` ms apart and admits those that wait
at most ``maxQueueingTimeMs``, with that wait. An event passes when all
of its pairs pass, and then its breaker decides.

A step decides its batch, then records every entry (PASS or BLOCK on
its row, its nodes and the inbound node, row 0), then its completions
(SUCCESS, EXCEPTION, RT sum and minimum, the RT histogram, the breakers'
windows). Thread gauges are kept only where a THREAD-grade rule reads
them (upstream's gauges are elided when nothing reads them). The
warm-up arithmetic is float32, with ``a · b + c`` rounded once (a fused
multiply-add), as the reference's JIT compiles it.

``counter_bits`` and ``rt_dtype`` set the precision of the stored
counters and RT sums, and ``batch_order=False`` judges every event
against the windows as they stood before its batch: the calibration's
controls run it below the configuration's precision (16-bit counters,
bfloat16 RT sums) and without the arrival order.
"""

from __future__ import annotations

import numpy as np
import torch


PASS, BLOCK, EXCEPTION, SUCCESS = 0, 1, 2, 3
EVENTS = 8
REASON_FLOW, REASON_DEGRADE = 1, 2
CLOSED, OPEN, HALF_OPEN = 0, 1, 2
NEVER = -(2 ** 30)
INT32_MAX = 2 ** 31 - 1
DEGRADE_EXCEPTION_RATIO, DEGRADE_EXCEPTION_COUNT = 1, 2
HIST_BUCKETS = 32


def wrap32(x: int) -> int:
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def wrap_bits(t: torch.Tensor, bits: int) -> None:
    """Wrap stored counts to ``bits`` wide, two's complement, in place."""
    half = 1 << (bits - 1)
    t.copy_(torch.remainder(t + half, 1 << bits) - half)


class Window:
    """One sliding window of ``rows`` resources: ``buckets`` buckets of
    ``win_ms`` each; bucket ``w % buckets`` holds window index ``w``
    when its stamp says so."""

    def __init__(self, rows: int, buckets: int, win_ms: int, device,
                 counter_bits: int, rt_dtype):
        self.buckets, self.win_ms, self.bits = buckets, win_ms, counter_bits
        self.counters = torch.zeros((rows, buckets, EVENTS),
                                    dtype=torch.int64, device=device)
        self.stamps = torch.full((rows, buckets), NEVER, dtype=torch.int64,
                                 device=device)
        self.rt_sum = torch.zeros((rows, buckets), dtype=rt_dtype,
                                  device=device)
        self.min_rt = torch.full((rows, buckets), INT32_MAX,
                                 dtype=torch.int64, device=device)

    def index(self, at_ms: int) -> int:
        return wrap32(at_ms // self.win_ms)

    def live_sum(self, rows: torch.Tensor, event: int, idx: int):
        """``event`` summed over the live buckets of ``rows``."""
        age = idx - self.stamps[rows]
        live = (age >= 0) & (age < self.buckets)
        return torch.where(live, self.counters[rows, :, event], 0).sum(1)

    def touch(self, rows: torch.Tensor, idx: int) -> int:
        """Start bucket ``idx`` afresh on ``rows`` where it holds an
        older index → the bucket."""
        k = idx % self.buckets
        stale = torch.zeros(self.stamps.shape[0], dtype=torch.bool,
                            device=rows.device)
        stale[rows] = True
        stale &= self.stamps[:, k] != idx
        self.counters[:, k, :].masked_fill_(stale[:, None], 0)
        self.rt_sum[:, k].masked_fill_(stale, 0)
        self.min_rt[:, k].masked_fill_(stale, INT32_MAX)
        self.stamps[:, k].masked_fill_(stale, idx)
        return k

    def add(self, rows: torch.Tensor, event: int, amounts: torch.Tensor,
            k: int) -> None:
        col = self.counters[:, k, event]
        col.index_add_(0, rows, amounts.to(torch.int64))
        wrap_bits(col, self.bits)

    def add_rt(self, rows: torch.Tensor, rt: torch.Tensor, k: int,
               rt_min=None) -> None:
        """RT sums ``rt`` onto ``rows``; their minima ``rt_min`` (``rt``
        itself by default)."""
        col = self.rt_sum[:, k]
        col.index_add_(0, rows, rt.to(col.dtype))
        mn = self.min_rt[:, k]
        mn.scatter_reduce_(0, rows, (rt if rt_min is None else rt_min)
                           .to(torch.int64), reduce="amin")


GRADE_THREAD, GRADE_QPS = 0, 1
DEFAULT, WARM_UP, RATE_LIMITER, WARM_UP_RATE_LIMITER = 0, 1, 2, 3
DIRECT, RELATE, CHAIN = 0, 1, 2
SEL_MAIN, SEL_ORIGIN, SEL_REF, SEL_CHAIN = 0, 1, 2, 3
LIMIT_DEFAULT, LIMIT_OTHER = -1, -2
H1, H2 = 0x9E3779B1, 0x85EBCA6B
COLD_FACTOR = 3.0


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once: the float64 product is exact,
    the float64 sum is rounded to odd, so that rounding it to float32 is
    correct."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    pp = s - c
    err = (p - pp) + (c - (s - pp))
    odd = (s.view(torch.int64) & 1) == 1
    nudge = torch.isfinite(s) & (err != 0) & ~odd
    s = torch.where(nudge, torch.nextafter(
        s, torch.where(err > 0, torch.inf, -torch.inf)), s)
    return s.float()


def f32_to_i32(x):
    """float32 → int32, truncating, saturating, NaN → 0."""
    big, small = x >= 2.0 ** 31, x < -(2.0 ** 31)
    out = torch.where(big | small | torch.isnan(x), 0.0, x).to(torch.int64)
    return torch.where(big, 2 ** 31 - 1, torch.where(small, -(2 ** 31), out))


class FirstSeen:
    """Ids in first-seen order, after the reserved ones."""

    def __init__(self, reserved: int = 1):
        self.ids = {}
        self.next = reserved

    def __call__(self, name: str) -> int:
        if name not in self.ids:
            self.ids[name] = self.next
            self.next += 1
        return self.ids[name]


class Reference:
    """See the module docstring. ``origins`` / ``contexts`` are the
    traffic's origin and context names, in the order the traffic names
    them; ``max_resources`` sizes the node table."""

    def __init__(self, names: int, flow, degrade, epoch_ms: int, device,
                 max_resources: int, origins=(), contexts=(),
                 minute: bool = True, second_buckets: int = 2,
                 second_ms: int = 1000, counter_bits: int = 32,
                 rt_dtype=torch.float64, batch_order: bool = True):
        dev = self.device = torch.device(device)
        self.epoch_ms = epoch_ms
        self.batch_order = batch_order
        # ---- ids, as registries hand them out --------------------------
        rows, orig, ctxs = FirstSeen(), FirstSeen(), FirstSeen()
        for rank, f in flow:
            rows(f"r{rank}")
            la = f.get("limit_app", "default")
            if la not in ("default", "other"):
                orig(la)
            if f.get("strategy", DIRECT) == RELATE:
                rows(f["ref_resource"])
            elif f.get("strategy", DIRECT) == CHAIN:
                ctxs(f["ref_resource"])
        for rank, _f in degrade:
            rows(f"r{rank}")
        row_of_rank = np.fromiter((rows(f"r{i}") for i in range(names)),
                                  np.int64, count=names)
        self.row_of_rank = torch.from_numpy(row_of_rank).to(dev)
        self.origin_id = torch.tensor([orig(o) for o in origins] or [0],
                                      dtype=torch.int64, device=dev)
        self.context_id = torch.tensor([ctxs(c) for c in contexts] or [0],
                                       dtype=torch.int64, device=dev)
        nrows = names + 1
        self.alt_rows = max(2 * max_resources, 1024)
        self.second = Window(nrows, second_buckets,
                             second_ms // second_buckets, dev, counter_bits,
                             rt_dtype)
        self.alt = Window(self.alt_rows, second_buckets,
                          second_ms // second_buckets, dev, counter_bits,
                          rt_dtype)
        self.minute = (Window(nrows, 60, 1000, dev, counter_bits, rt_dtype)
                       if minute else None)
        self.threads = torch.zeros(nrows, dtype=torch.int64, device=dev)
        self.alt_threads = torch.zeros(self.alt_rows, dtype=torch.int64,
                                       device=dev)
        self.hist = torch.zeros((nrows, HIST_BUCKETS), dtype=torch.int64,
                                device=dev)
        self.bits = counter_bits
        self.windows = {"second": second_ms // second_buckets,
                        "alt_second": second_ms // second_buckets}
        if minute:
            self.windows["minute"] = 1000
        # ---- flow rules ------------------------------------------------
        nf = len(flow)
        grade = np.zeros(nf, np.int64)
        behavior = np.zeros(nf, np.int64)
        count = np.zeros(nf, np.float32)
        sel = np.zeros(nf, np.int64)
        ref_row = np.zeros(nf, np.int64)
        ref_ctx = np.full(nf, -1, np.int64)
        limit = np.full(nf, LIMIT_DEFAULT, np.int64)
        maxq = np.zeros(nf, np.int64)
        warning = np.zeros(nf, np.float32)
        max_token = np.zeros(nf, np.float32)
        slope = np.zeros(nf, np.float32)
        rule_row = np.zeros(nf, np.int64)
        by_row = {}
        for j, (rank, f) in enumerate(flow):
            row = rows(f"r{rank}")
            by_row.setdefault(row, []).append(j)
            rule_row[j] = row
            grade[j] = f.get("grade", GRADE_QPS)
            behavior[j] = f.get("control_behavior", DEFAULT)
            count[j] = f["count"]
            maxq[j] = f.get("max_queueing_time_ms", 500)
            la = f.get("limit_app", "default")
            limit[j] = (LIMIT_DEFAULT if la == "default" else
                        LIMIT_OTHER if la == "other" else orig(la))
            strat = f.get("strategy", DIRECT)
            if strat == RELATE:
                sel[j] = SEL_REF
                ref_row[j] = rows(f["ref_resource"])
            elif strat == CHAIN:
                sel[j] = SEL_CHAIN
                ref_ctx[j] = ctxs(f["ref_resource"])
            else:
                sel[j] = SEL_MAIN if la == "default" else SEL_ORIGIN
            if behavior[j] in (WARM_UP, WARM_UP_RATE_LIMITER):
                # WarmUpController's constructor, in double precision
                period, c = f.get("warm_up_period_sec", 10), f["count"]
                wt = (period * c) / (COLD_FACTOR - 1.0)
                mt = wt + 2.0 * period * c / (1.0 + COLD_FACTOR)
                warning[j], max_token[j] = wt, mt
                slope[j] = (COLD_FACTOR - 1.0) / c / max(mt - wt, 1e-9)
        k = max((len(v) for v in by_row.values()), default=1)
        slots = np.full((nrows, k), nf, np.int64)
        for row, js in by_row.items():
            slots[row, :len(js)] = js

        def t(a):
            return torch.from_numpy(a).to(dev)
        self.nf, self.k = nf, k
        self.slots = t(slots)
        (self.grade, self.behavior, self.count, self.sel, self.ref_row,
         self.ref_ctx, self.limit, self.maxq, self.warning, self.max_token,
         self.slope) = map(t, (grade, behavior, count, sel, ref_row,
                              ref_ctx, limit, maxq, warning, max_token,
                              slope))
        self.sync_row = t(np.where(sel == SEL_REF, ref_row, rule_row))
        self.is_wu = (((self.behavior == WARM_UP)
                       | (self.behavior == WARM_UP_RATE_LIMITER))
                      & (self.grade == GRADE_QPS))
        self.gauges = bool((self.grade == GRADE_THREAD).any())
        self.is_rl = (((self.behavior == RATE_LIMITER)
                       | (self.behavior == WARM_UP_RATE_LIMITER))
                      & (self.grade == GRADE_QPS))
        self.latest = torch.full((nf,), NEVER, dtype=torch.int64,
                                 device=dev)
        self.stored = torch.zeros(nf, dtype=torch.float32, device=dev)
        self.last_filled = torch.full((nf,), NEVER, dtype=torch.int64,
                                      device=dev)
        # (row, origin) pairs that a named-origin rule of the row names
        named = sorted({int(rule_row[j]) * (1 << 20) + int(limit[j])
                        for j in range(nf) if limit[j] >= 0})
        self.named = torch.tensor(named or [-1], dtype=torch.int64,
                                  device=dev)
        # ---- breakers --------------------------------------------------
        self._init_breakers(degrade, rows)

    def _init_breakers(self, degrade, rows) -> None:
        dev = self.device
        nd = len(degrade)
        deg_of_row = np.full(self.second.stamps.shape[0], -1, np.int64)
        for j, (rank, f) in enumerate(degrade):
            if f["grade"] not in (DEGRADE_EXCEPTION_RATIO,
                                  DEGRADE_EXCEPTION_COUNT):
                raise NotImplementedError("exception breakers only")
            row = rows(f"r{rank}")
            if deg_of_row[row] >= 0:
                raise NotImplementedError("one breaker a resource")
            deg_of_row[row] = j
        self.deg_of_row = torch.from_numpy(deg_of_row).to(dev)

        def col(key, default=None, dtype=torch.int64):
            return torch.tensor([f.get(key, default) for _r, f in degrade],
                                dtype=dtype, device=dev)
        self.deg_grade = col("grade")
        self.deg_count = col("count", dtype=torch.float64)
        self.deg_retry = col("time_window") * 1000
        self.deg_min = col("min_request_amount", 5)
        self.deg_interval = col("stat_interval_ms", 1000)
        self.brk_state = torch.zeros(nd, dtype=torch.int64, device=dev)
        self.brk_retry = torch.full((nd,), NEVER, dtype=torch.int64,
                                    device=dev)
        self.brk_stamp = torch.full((nd,), NEVER, dtype=torch.int64,
                                    device=dev)
        self.brk_bad = torch.zeros(nd, dtype=torch.int64, device=dev)
        self.brk_total = torch.zeros(nd, dtype=torch.int64, device=dev)

    # ---- the traffic's identities -------------------------------------

    def node(self, rows, kind: int, ids):
        """The node-table row of (resource row, origin or context id)."""
        h = ((rows * H1) ^ ((ids * 2 + kind) * H2)) & 0xFFFFFFFF
        return h % self.alt_rows

    def nodes(self, rows, origin, context):
        """(origin id, origin node, context id, context node) of events
        of origin index ``origin`` and context index ``context`` (-1:
        none; the node is then ``alt_rows``)."""
        ra = self.alt_rows
        oid = torch.where(origin >= 0,
                          self.origin_id[origin.clamp(min=0)], 0)
        cid = torch.where(context >= 0,
                          self.context_id[context.clamp(min=0)], 0)
        onode = torch.where(origin >= 0, self.node(rows, 0, oid), ra)
        cnode = torch.where(context >= 0, self.node(rows, 1, cid), ra)
        return oid, onode, cid, cnode

    # ---- one step ----------------------------------------------------

    def step(self, ranks, at_ms: int, origin=None, context=None,
             exit_ranks=None, exit_rt=None, exit_err=None,
             exit_origin=None, exit_context=None):
        """Decide the batch (every event acquires 1 and comes in), then
        record the exits → ``(allow, reason, wait_ms)``."""
        dev = self.device
        rows = self.row_of_rank[ranks.to(dev, torch.int64)]
        n = rows.shape[0]
        none = torch.full((n,), -1, dtype=torch.int64, device=dev)
        origin = none if origin is None else origin.to(dev, torch.int64)
        context = none if context is None else context.to(dev, torch.int64)
        oid, onode, cid, cnode = self.nodes(rows, origin, context)
        # a batch without origins and contexts touches no node
        has_nodes = origin is not none or context is not none
        rel = wrap32(at_ms - self.epoch_ms)
        idx_s = self.second.index(at_ms)
        self._warm_up(at_ms, rel)
        flow_ok, wait = self._flow(rows, oid, onode, cid, cnode, idx_s, rel)
        allow, reason = self._degrade(rows, flow_ok, rel)
        wait = torch.where(allow, wait, 0)
        self._record_entries(rows, onode, cnode, allow, at_ms, has_nodes)
        if exit_ranks is not None and exit_ranks.numel():
            xr = self.row_of_rank[exit_ranks.to(dev, torch.int64)]
            xn = torch.full_like(xr, -1)
            xo = xn if exit_origin is None else exit_origin.to(dev).long()
            xc = xn if exit_context is None else exit_context.to(dev).long()
            _o, xon, _c, xcn = self.nodes(xr, xo, xc)
            self._record_exits(xr, xon, xcn, exit_rt.to(dev).long(),
                               exit_err.to(dev, torch.bool), at_ms, rel,
                               has_nodes)
        return allow, reason, wait.to(torch.int32)

    def _warm_up(self, at_ms: int, rel: int) -> None:
        """WarmUpController.syncToken once a step, for every rule."""
        if self.minute is not None:
            w = self.minute
        else:
            w = self.second
        prev = wrap32(w.index(at_ms) - 1)
        k = prev % w.buckets
        r = self.sync_row
        pass_prev = torch.where(w.stamps[r, k] == prev,
                                w.counters[r, k, PASS], 0).float()
        now_sec = rel // 1000
        sync = self.is_wu & (now_sec > self.last_filled)
        old = self.stored
        elapsed = (now_sec - self.last_filled).float()
        cold = torch.full_like(self.count, COLD_FACTOR)
        refill = (old < self.warning) | (
            (old > self.warning) & (pass_prev < self.count / cold))
        refilled = torch.minimum(fma32(elapsed, self.count, old),
                                 self.max_token)
        new = torch.clamp(torch.where(refill, refilled, old) - pass_prev,
                          min=0.0)
        self.stored = torch.where(sync, new, old)
        self.last_filled = torch.where(sync, now_sec, self.last_filled)
        above = torch.clamp(self.stored - self.warning, min=0.0)
        qps = 1.0 / fma32(above, self.slope,
                          1.0 / torch.clamp(self.count, min=1e-9))
        self.limit_now = torch.where(self.is_wu & (self.stored
                                                   >= self.warning),
                                     qps, self.count)

    def _flow(self, rows, oid, onode, cid, cnode, idx_s: int, rel: int):
        dev = self.device
        n, k, nf = rows.shape[0], self.k, self.nf
        ev = torch.arange(n, device=dev).repeat_interleave(k)
        rule = self.slots[rows].reshape(-1)                    # [n·k]
        has = rule < nf
        j = torch.where(has, rule, 0)
        lim = self.limit[j]
        o = oid[ev]
        named = torch.isin(rows[ev] * (1 << 20) + o, self.named)
        app = ((lim == LIMIT_DEFAULT) | (lim == o)
               | ((lim == LIMIT_OTHER) & (o != 0) & ~named))
        kind = self.sel[j]
        app &= (kind != SEL_CHAIN) | (cid[ev] == self.ref_ctx[j])
        alt = (kind == SEL_ORIGIN) | (kind == SEL_CHAIN)
        node = torch.where(kind == SEL_CHAIN, cnode[ev], onode[ev])
        app &= ~alt | (node < self.alt_rows)
        app &= has
        main = torch.where(kind == SEL_REF, self.ref_row[j], rows[ev])
        node_c = node.clamp(max=self.alt_rows - 1)
        base_pass = torch.where(
            alt, self.alt.live_sum(node_c, PASS, idx_s),
            self.second.live_sum(main, PASS, idx_s))
        base_thr = torch.where(alt, self.alt_threads[node_c],
                               self.threads[main])
        base = torch.where(self.grade[j] == GRADE_QPS, base_pass, base_thr)
        # arrival rank of each applying pair on its rule and node (on its
        # rule alone for a rate limiter)
        rl = self.is_rl[j]
        nrows = self.second.stamps.shape[0]
        seg_node = torch.where(rl, 0, torch.where(alt, node + nrows, main))
        key = torch.where(app, j * (1 << 23) + seg_node, -1)
        sk, order = torch.sort(key, stable=True)
        first = torch.searchsorted(sk, sk)
        rank = torch.empty_like(key)
        rank[order] = torch.arange(key.shape[0], device=dev) - first
        if not self.batch_order:
            rank.zero_()
        limit = self.limit_now[j].double()
        ok_count = (base.double() + (rank + 1).double()) <= limit
        # RATE_LIMITER: pacing per rule
        cost = f32_to_i32(torch.round(
            torch.ones_like(self.count) / torch.clamp(self.count, min=1e-9)
            * 1000.0))
        due = (self.latest + cost - rel) <= 0
        base_time = torch.where(due, rel - cost, self.latest)
        latest = base_time[j] + (rank + 1) * cost[j]
        wait_pair = torch.clamp(latest - rel, min=0)
        ok_rl = (wait_pair <= self.maxq[j]) & (self.count[j] > 0)
        ok = torch.where(rl, ok_rl, ok_count) | ~app
        paced = rl & app & ok
        newest = torch.full((nf + 1,), NEVER, dtype=torch.int64, device=dev)
        newest.scatter_reduce_(0, torch.where(paced, j, nf), latest,
                               reduce="amax")
        self.latest = torch.maximum(self.latest, newest[:nf])
        allow = ok.reshape(n, k).all(1)
        wait = torch.where(paced, wait_pair, 0).reshape(n, k).max(1).values
        return allow, wait

    def _degrade(self, rows, flow_ok, rel: int):
        n = rows.shape[0]
        ar = torch.arange(n, device=self.device)
        d = self.deg_of_row[rows]
        gated = flow_ok & (d >= 0)
        dd = torch.where(gated, d, 0)
        nd = self.brk_state.shape[0]
        due = (self.brk_state == OPEN) & (rel - self.brk_retry >= 0)
        probe = torch.full((nd + 1,), n, dtype=torch.int64,
                           device=self.device)
        probe = probe.scatter_reduce_(0, torch.where(gated, dd, nd), ar,
                                      reduce="amin")[:nd]
        is_probe = gated & due[dd] & (probe[dd] == ar)
        deg_ok = ~gated | (self.brk_state[dd] == CLOSED) | is_probe
        self.brk_state = torch.where(due & (probe < n), HALF_OPEN,
                                     self.brk_state)
        allow = flow_ok & deg_ok
        reason = torch.where(~flow_ok, REASON_FLOW,
                             torch.where(~deg_ok, REASON_DEGRADE, 0))
        return allow, reason.to(torch.int8)

    def _record_entries(self, rows, onode, cnode, allow, at_ms,
                        has_nodes: bool) -> None:
        entry = rows.new_zeros(1)
        a, b = allow.long(), (~allow).long()
        for w in [w for w in (self.second, self.minute) if w is not None]:
            kk = w.touch(torch.cat([rows, entry]), w.index(at_ms))
            w.add(rows, PASS, a, kk)
            w.add(rows, BLOCK, b, kk)
            w.add(entry, PASS, a.sum().reshape(1), kk)
            w.add(entry, BLOCK, b.sum().reshape(1), kk)
        if self.gauges:
            self.threads.index_add_(0, rows, a)
            self.threads[0] += a.sum()
            wrap_bits(self.threads, self.bits)
        if not has_nodes:
            return
        nodes = torch.cat([onode, cnode])
        live = nodes < self.alt_rows
        nodes, a2, b2 = nodes[live], torch.cat([a, a])[live], torch.cat(
            [b, b])[live]
        kk = self.alt.touch(nodes, self.alt.index(at_ms))
        self.alt.add(nodes, PASS, a2, kk)
        self.alt.add(nodes, BLOCK, b2, kk)
        if self.gauges:
            self.alt_threads.index_add_(0, nodes, a2)
            wrap_bits(self.alt_threads, self.bits)

    def _record_exits(self, rows, onode, cnode, rt, err, at_ms, rel,
                      has_nodes: bool):
        entry = rows.new_zeros(1)
        ones = torch.ones_like(rows)
        e = err.long()
        for w in [w for w in (self.second, self.minute) if w is not None]:
            kk = w.touch(torch.cat([rows, entry]), w.index(at_ms))
            w.add(rows, SUCCESS, ones, kk)
            w.add(rows, EXCEPTION, e, kk)
            w.add(entry, SUCCESS, ones.sum().reshape(1), kk)
            w.add(entry, EXCEPTION, e.sum().reshape(1), kk)
            w.add_rt(rows, rt, kk)
            w.add_rt(entry, rt.sum().reshape(1), kk, rt.min().reshape(1))
        if self.gauges:
            self.threads.index_add_(0, rows, -ones)
            self.threads[0] -= rows.shape[0]
            self.threads.clamp_(min=0)
        if has_nodes:
            nodes = torch.cat([onode, cnode])
            live = nodes < self.alt_rows
            nodes = nodes[live]
            kk = self.alt.touch(nodes, self.alt.index(at_ms))
            self.alt.add(nodes, SUCCESS, torch.ones_like(nodes), kk)
            self.alt.add(nodes, EXCEPTION, torch.cat([e, e])[live], kk)
            self.alt.add_rt(nodes, torch.cat([rt, rt])[live], kk)
            if self.gauges:
                self.alt_threads.index_add_(0, nodes,
                                            -torch.ones_like(nodes))
                self.alt_threads.clamp_(min=0)
        edges = torch.pow(2, torch.arange(HIST_BUCKETS - 1,
                                          device=self.device))
        hb = (rt[:, None] > edges).sum(1)
        self.hist.view(-1).index_add_(0, rows * HIST_BUCKETS + hb, ones)
        wrap_bits(self.hist, self.bits)
        self._feed_breakers(rows, err, rel)

    def _feed_breakers(self, rows, err, rel: int) -> None:
        d = self.deg_of_row[rows]
        m = d >= 0
        if not bool(m.any()):
            return
        d, bad = d[m], err[m].long()
        nd = self.brk_state.shape[0]
        ar = torch.arange(d.shape[0], device=self.device)
        first = torch.full((nd,), d.shape[0], dtype=torch.int64,
                           device=self.device)
        first.scatter_reduce_(0, d, ar, reduce="amin")
        seen = first < d.shape[0]
        first_bad = bad[torch.clamp(first, max=d.shape[0] - 1)] > 0
        half = (self.brk_state == HALF_OPEN) & seen
        fail, ok = half & first_bad, half & ~first_bad
        self.brk_state = torch.where(fail, OPEN,
                                     torch.where(ok, CLOSED, self.brk_state))
        self.brk_retry = torch.where(fail, rel + self.deg_retry,
                                     self.brk_retry)
        self.brk_stamp = torch.where(ok, NEVER, self.brk_stamp)
        widx = torch.div(torch.full_like(self.deg_interval, rel),
                         self.deg_interval, rounding_mode="floor")
        restart = seen & (self.brk_stamp != widx)
        self.brk_bad = torch.where(restart, 0, self.brk_bad)
        self.brk_total = torch.where(restart, 0, self.brk_total)
        self.brk_stamp = torch.where(seen, widx, self.brk_stamp)
        self.brk_bad.index_add_(0, d, bad)
        self.brk_total.index_add_(0, d, torch.ones_like(d))
        enough = self.brk_total >= self.deg_min
        ratio_trip = (self.brk_bad.double()
                      > self.deg_count * self.brk_total.clamp(min=1))
        count_trip = self.brk_bad.double() >= self.deg_count
        trip = enough & torch.where(
            self.deg_grade == DEGRADE_EXCEPTION_COUNT, count_trip,
            ratio_trip) & (self.brk_state == CLOSED)
        self.brk_state = torch.where(trip, OPEN, self.brk_state)
        self.brk_retry = torch.where(trip, rel + self.deg_retry,
                                     self.brk_retry)

    # ---- what the comparison reads -------------------------------------

    def leaves(self) -> dict:
        out = {}
        for tag, w in (("second", self.second), ("minute", self.minute),
                       ("alt_second", self.alt)):
            if w is None:
                continue
            out[f"{tag}.counters"] = w.counters
            out[f"{tag}.stamps"] = w.stamps
            out[f"{tag}.rt_sum"] = w.rt_sum
            out[f"{tag}.min_rt"] = w.min_rt
        out["rt_hist"] = self.hist
        out["threads"] = self.threads
        out["alt_threads"] = self.alt_threads
        out["flow_dyn.latest_passed_ms"] = self.latest
        out["flow_dyn.last_filled_sec"] = self.last_filled
        out["flow_dyn.stored_tokens"] = self.stored
        out["breakers.state"] = self.brk_state
        out["breakers.next_retry_ms"] = self.brk_retry
        out["breakers.win_stamp"] = self.brk_stamp
        out["breakers.bad"] = self.brk_bad
        out["breakers.total"] = self.brk_total
        return out



def build(config: dict, rules: dict, traffic, epoch_ms: int, device,
          **precision) -> Reference:
    """The reference of a configuration: its sizes, its rules by kind
    (``{"flow": [...], "degrade": [...]}`` of ``(rank, fields)``), the
    traffic's origin and context names and the program's time base;
    ``precision`` as :class:`Reference` takes it (the controls)."""
    sp = config["sentinel"]
    return Reference(
        config["names"], rules.get("flow", ()), rules.get("degrade", ()),
        epoch_ms, device, max_resources=sp["max_resources"],
        origins=traffic.origin_names, contexts=traffic.context_names,
        minute=sp.get("minute_enabled", True),
        second_buckets=sp.get("second_sample_count", 2),
        second_ms=sp.get("second_interval_ms", 1000), **precision)
