"""Plain reference of Sentinel's hot-parameter flow control on top of
:mod:`portbench.reference.sentinel`: ``ParamFlowSlot`` between the system
and the flow slots, each rule checking its call argument ``paramIdx``
with ``ParamFlowChecker``'s semantics, one batch step at a time.

Written from the published checker (``ParamFlowChecker.
passDefaultLocalCheck``, ``passThrottleLocalCheck``, ``ParamFlowRule``,
``ParamFlowItem``), in plain PyTorch; it imports nothing of the program.
State is kept by (rule position, value): a sorted table of packed keys
``position · 2^32 + value + 2^31`` and, aligned with it, each key's
token bucket (upstream's ``tokenCounters``), the time of its last refill
(``timeCounters`` of a DEFAULT rule) and its pacing clock (the
``timeRecorderMap`` of a RATE_LIMITER rule). A key joins the table when
an event first applies it.

An event applies each of its resource's rules in load order whose index
lies within its arguments, to the argument at that index. Per
application, with ``a`` the acquire count (1) and the threshold the
value's hot-item count, else the rule's (upstream's ``(long) count``):

* DEFAULT: the bucket as the application finds it is ``count + burst``
  the first time, refilled by ``passTime · threshold / duration``
  (integer division) and capped at ``count + burst`` once more than the
  rule's duration has passed since its last refill, else as it was; the
  application passes while its arrival rank among the batch's
  applications of the key, plus one, times ``a`` stays within it, and
  never with a zero threshold or ``a`` above the cap;
* RATE_LIMITER: ``cost = round(1000 · a · durationInSec / threshold)``;
  the queue starts at ``now − cost`` when it is due (never used, or its
  clock plus ``cost`` not after now), else at its clock; the application
  of rank ``k`` would pass at ``start + (k + 1) · cost`` and passes when
  that wait is at most 0 or under ``maxQueueingTimeMs``, with that wait.

An event passes the slot when all of its applications pass; one that
fails is blocked with reason PARAM_FLOW and takes no flow quota (the
flow slot sees only the events the param slot passed), and its wait is
the longest wait of its applications. Then the batch's buckets take the
tokens of the applications of passed events, a refilled key's refill
time becomes now, and a pacing clock moves to the latest passing time
of a passed event's application.

Departures from the published checker, each the port's stated
semantics (``configs/hotparam_1m.json``, ``assumed``): a batch is
decided at one instant, so an application's rank counts every earlier
application of its key in the batch, and an event whose other rule
blocks takes no token and no pacing time (upstream's slot chain takes
rule A's token before rule B throws); the port keeps buckets in float32
and rounds a pacing cost of exactly ``x.5`` its own way, which the
configuration's integer counts below 2^24 and costs of 10 ms never
meet. ``batch_order=False`` judges every application at rank 0, as the
base reference judges its events.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import sentinel as base

REASON_PARAM_FLOW = 5
GRADE_QPS = 1
DEFAULT, RATE_LIMITER = 0, 2
NEVER = base.NEVER


def pack(pos, value):
    """The table's key of (rule position, value)."""
    return pos * (1 << 32) + (value + (1 << 31))


class Reference(base.Reference):
    """:class:`base.Reference` with the param slot; ``param`` is the
    configuration's param rules as ``[(rank, fields)]`` in load order."""

    def __init__(self, names: int, flow, degrade, param, epoch_ms: int,
                 device, **kw):
        super().__init__(names, flow, degrade, epoch_ms, device, **kw)
        dev = self.device
        nrows = self.second.stamps.shape[0]
        by_row = {}
        for j, (rank, _f) in enumerate(param):
            by_row.setdefault(int(self.row_of_rank[rank]), []).append(j)
        k = max((len(v) for v in by_row.values()), default=1)
        slots = np.full((nrows, k), -1, np.int64)
        idx = np.zeros((nrows, k), np.int64)
        hot = {}
        for row, js in by_row.items():
            for c, j in enumerate(js):
                f = param[j][1]
                slots[row, c] = j
                idx[row, c] = f.get("param_idx", 0)
                for it in f.get("param_flow_item_list", ()):
                    hot[int(pack(j, int(it["object"])))] = int(it["count"])

        def col(key, default, dtype=torch.int64):
            return torch.tensor([f.get(key, default) for _r, f in param]
                                or [default], dtype=dtype, device=dev)
        self.p_slots = torch.from_numpy(slots).to(dev)
        self.p_idx = torch.from_numpy(idx).to(dev)
        self.p_count = torch.tensor([int(f["count"]) for _r, f in param]
                                    or [0], dtype=torch.int64, device=dev)
        self.p_burst = col("burst_count", 0)
        self.p_dur_s = col("duration_in_sec", 1)
        self.p_maxq = col("max_queueing_time_ms", 0)
        self.p_rl = ((col("control_behavior", DEFAULT) == RATE_LIMITER)
                     & (col("grade", GRADE_QPS) == GRADE_QPS))
        hk = sorted(hot)
        self.hot_keys = torch.tensor(hk or [-1], dtype=torch.int64,
                                     device=dev)
        self.hot_counts = torch.tensor([hot[x] for x in hk] or [0],
                                       dtype=torch.int64, device=dev)
        # the key table, sorted by key
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        self.pk_keys = empty
        self.pk_tokens = empty
        self.pk_fill = empty
        self.pk_latest = empty
        self.pk_thr = empty
        self._args = None
        self._param_ok = None

    # ---- the key table -------------------------------------------------

    def _threshold(self, keys):
        """Each key's hot-item count, else its rule's count."""
        at = torch.searchsorted(self.hot_keys, keys).clamp(
            max=self.hot_keys.shape[0] - 1)
        hit = self.hot_keys[at] == keys
        return torch.where(hit, self.hot_counts[at],
                           self.p_count[keys >> 32])

    def _find(self, keys):
        """The table's index of each of ``keys``, those not in it added
        (an empty bucket, never refilled, never paced)."""
        new = torch.unique(keys)
        new = new[~torch.isin(new, self.pk_keys)]
        if new.numel():
            self.pk_keys, order = torch.sort(torch.cat([self.pk_keys, new]))

            def grow(t, fill):
                return torch.cat([t, fill])[order]
            self.pk_tokens = grow(self.pk_tokens, torch.zeros_like(new))
            self.pk_fill = grow(self.pk_fill, torch.full_like(new, NEVER))
            self.pk_latest = grow(self.pk_latest, torch.full_like(new, NEVER))
            self.pk_thr = grow(self.pk_thr, self._threshold(new))
        return torch.searchsorted(self.pk_keys, keys)

    # ---- one step ----------------------------------------------------

    def step(self, ranks, at_ms: int, args=None, exit_args=None, **kw):
        """:meth:`base.Reference.step`, the events' arguments ``args``
        (``[n, A]``) put through the param slot first."""
        self._args = args
        return super().step(ranks, at_ms, **kw)

    def _flow(self, rows, oid, onode, cid, cnode, idx_s: int, rel: int):
        ok, pwait = self._param(rows, rel)
        self._param_ok = ok
        sub = torch.nonzero(ok).view(-1)
        allow = torch.zeros_like(ok)
        wait = torch.zeros(rows.shape[0], dtype=torch.int64,
                           device=self.device)
        if sub.numel():
            a, w = super()._flow(rows[sub], oid[sub], onode[sub], cid[sub],
                                 cnode[sub], idx_s, rel)
            allow[sub] = a
            wait[sub] = w.to(torch.int64)
        return allow, torch.maximum(wait, pwait)

    def _degrade(self, rows, flow_ok, rel: int):
        allow, reason = super()._degrade(rows, flow_ok, rel)
        return allow, torch.where(self._param_ok, reason,
                                  REASON_PARAM_FLOW).to(torch.int8)

    def _param(self, rows, rel: int):
        """The param slot over the batch → (passed bool[n], wait int64[n]);
        the key table updated."""
        dev = self.device
        n = rows.shape[0]
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        wait = torch.zeros(n, dtype=torch.int64, device=dev)
        if self._args is None:
            return ok, wait
        args = self._args.to(dev, torch.int64)
        j = self.p_slots[rows]
        idx = self.p_idx[rows]
        app = (j >= 0) & (idx < args.shape[1])
        ev, kk = torch.nonzero(app, as_tuple=True)       # arrival order
        if not ev.numel():
            return ok, wait
        jj = j[ev, kk]
        value = args[ev, idx[ev, kk]]
        q = self._find(pack(jj, value))
        # arrival rank of each application among the batch's of its key
        sk, order = torch.sort(q, stable=True)
        first = torch.searchsorted(sk, sk)
        rank = torch.empty_like(q)
        rank[order] = torch.arange(q.shape[0], device=dev) - first
        if not self.batch_order:
            rank.zero_()
        a = 1
        thr = self.pk_thr[q]
        cap = thr + self.p_burst[jj]
        rl = self.p_rl[jj]
        # DEFAULT: the bucket as the application finds it
        dur = self.p_dur_s[jj] * 1000
        last = self.pk_fill[q]
        never = last == NEVER
        passed_ms = rel - last
        refill = ~never & (passed_ms > dur)
        tok = torch.where(never, cap, torch.where(
            refill, torch.minimum(self.pk_tokens[q] + passed_ms * thr // dur,
                                  cap), self.pk_tokens[q]))
        ok_default = ((rank + 1) * a <= tok) & (thr > 0) & (a <= cap)
        # RATE_LIMITER: the paced queue
        cost = torch.floor(1000.0 * a * self.p_dur_s[jj].double()
                           / thr.clamp(min=1).double() + 0.5).long()
        l0 = self.pk_latest[q]
        due = (l0 == NEVER) | (l0 + cost - rel <= 0)
        start = torch.where(due, rel - cost, l0)
        at = start + (rank + 1) * cost
        w = torch.clamp(at - rel, min=0)
        ok_rl = ((w <= 0) | (w < self.p_maxq[jj])) & (thr > 0)
        good = torch.where(rl, ok_rl, ok_default)
        bad = torch.zeros(n, dtype=torch.int64, device=dev)
        bad.index_add_(0, ev, (~good).long())
        ok = bad == 0
        wait.scatter_reduce_(0, ev, torch.where(rl & good, w, 0),
                             reduce="amax")
        wait = torch.where(ok, wait, 0)
        # the batch's buckets and clocks, by the events that passed
        took = good & ok[ev]
        d = ~rl
        if bool(d.any()):
            qd = q[d]
            self.pk_tokens[qd] = tok[d]
            self.pk_tokens.index_add_(0, qd, -(took[d].long() * a))
            self.pk_fill[qd[(never | refill)[d]]] = rel
        paced = rl & took
        if bool(paced.any()):
            self.pk_latest.scatter_reduce_(0, q[paced], at[paced],
                                        reduce="amax")
        return ok, wait

    # ---- what the comparison reads -------------------------------------

    def leaves(self) -> dict:
        out = super().leaves()
        out["param_buckets.count"] = torch.tensor(
            [self.pk_keys.shape[0]], dtype=torch.int64, device=self.device)
        out["param_buckets.keys"] = self.pk_keys
        out["param_buckets.tokens"] = self.pk_tokens.double()
        out["param_buckets.last_fill_ms"] = self.pk_fill
        out["param_buckets.latest_passed_ms"] = self.pk_latest
        out["param_buckets.threshold"] = self.pk_thr.double()
        return out


def build(config: dict, rules: dict, traffic, epoch_ms: int, device,
          **precision) -> Reference:
    """:func:`base.build` with the configuration's param rules."""
    sp = config["sentinel"]
    return Reference(
        config["names"], rules.get("flow", ()), rules.get("degrade", ()),
        rules.get("param", ()), epoch_ms, device,
        max_resources=sp["max_resources"], origins=traffic.origin_names,
        contexts=traffic.context_names,
        minute=sp.get("minute_enabled", True),
        second_buckets=sp.get("second_sample_count", 2),
        second_ms=sp.get("second_interval_ms", 1000), **precision)
