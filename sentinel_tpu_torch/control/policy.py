"""The pure overload-policy core: telemetry in, typed actions out.

Port of ``sentinel_tpu/control/policy.py`` (host Python; a copy, since
the port imports nothing of the JAX package). No engine, no asyncio, no
wall clock — every method takes explicit timestamps, so tests drive the
whole control law under a ManualClock. The runner
(:mod:`~sentinel_tpu_torch.control.loop`) feeds it :class:`Observation`
rows built from the per-second telemetry timeline, the rolling
``hist_request`` latency histogram and the ingest queue depth; it emits
:class:`ShedRate` / :class:`RetuneBatcher` / :class:`Degrade` actions for
the actuators to apply.

Control law (BBR-flavored AIMD):

* **Estimation** — :class:`HistDeltaP99` diffs consecutive cumulative
  histogram snapshots, so the controller reacts to the p99 of the LAST
  interval; :class:`WindowedFilter` keeps windowed-max delivery rate and
  windowed-min RT estimates, the headroom pair the snapshot reports.
* **Decision** — multiplicative backoff of the admitted fraction when the
  interval p99 crosses ``p99_hi_ms`` (or the ingest queue passes
  ``queue_hi_frac`` of its bound), additive recovery below ``p99_lo_ms``;
  the band between them holds. Every action key has its own
  ``cooldown_ms`` stamp.
* **Degrade** — per-resource three-state trackers: ``degrade_bad_ticks``
  consecutive bad intervals force the resource's breaker OPEN,
  ``degrade_hold_ms`` later it is probed HALF_OPEN, and one good interval
  closes it (one bad re-opens). Off unless ``degrade_rt_ms`` > 0. The
  signal is each hot resource's interval p99 from the device RT
  histogram table (``Observation.resource_p99``, from the loop's
  :class:`~sentinel_tpu_torch.obs.resource_hist.ResourceTailTracker`);
  with histograms off, the hot set's mean RT (``Observation.resource_rt``).
"""

from __future__ import annotations

import collections
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from sentinel_tpu_torch.obs.hist import BASE_NS, NUM_BUCKETS

# Degrade.transition values (applied via Sentinel.force_breaker)
DEG_OPEN = "open"
DEG_HALF_OPEN = "half_open"
DEG_CLOSE = "close"


class Observation(NamedTuple):
    """One controller tick's view of the system (all host-side)."""

    ts_ms: int                      # clock stamp of the tick
    pass_per_s: float               # last landed second's pass count
    block_per_s: float              # last landed second's block count
    rt_avg_ms: float                # device RT mean over that second
    p99_ms: float                   # interval p99 of hist_request (0=idle)
    queue_depth: int                # frontend pending (queued + inflight)
    queue_max: int                  # frontend backpressure bound (0=none)
    resource_rt: Tuple[Tuple[str, float], ...] = ()   # hot-set mean RT
    # hot-set interval p99 from the device RT histogram
    # deltas; when non-empty it supersedes resource_rt in the degrade
    # trackers (resource_rt stays as the hist-disabled fallback)
    resource_p99: Tuple[Tuple[str, float], ...] = ()


class ShedRate(NamedTuple):
    """Set the frontend admission fraction (1.0 = wide open)."""

    frac: float


class RetuneBatcher(NamedTuple):
    """Hot-swap the batcher's flush reserve and batch cap online."""

    budget_ms: int
    batch_cap: int


class Degrade(NamedTuple):
    """Force a resource's breaker: open | half_open | close."""

    resource: str
    transition: str


def action_kind(action) -> str:
    """Stable action-family name (counter / Prometheus label)."""
    return {ShedRate: "shed_rate", RetuneBatcher: "retune_batcher",
            Degrade: "degrade"}[type(action)]


class WindowedFilter:
    """BBR-style windowed extremum: the max (or min) sample over the
    trailing ``window_ms``. O(1) amortized via a monotonic deque."""

    def __init__(self, window_ms: int, mode: str = "max"):
        self.window_ms = max(1, int(window_ms))
        self._better = (lambda a, b: a >= b) if mode == "max" \
            else (lambda a, b: a <= b)
        self._q: "collections.deque[Tuple[int, float]]" = collections.deque()

    def update(self, ts_ms: int, value: float) -> float:
        q = self._q
        while q and self._better(value, q[-1][1]):
            q.pop()
        q.append((int(ts_ms), float(value)))
        while q and ts_ms - q[0][0] > self.window_ms:
            q.popleft()
        return q[0][1]

    @property
    def value(self) -> Optional[float]:
        return self._q[0][1] if self._q else None


class HistDeltaP99:
    """Interval p99 from a CUMULATIVE log-histogram bucket vector: diff
    against the previous snapshot, interpolate inside the landing bucket
    (same geometry as obs/hist.py). → p99 in ms of requests recorded
    since the last call; 0.0 when the interval recorded nothing."""

    def __init__(self) -> None:
        self._prev: Optional[List[int]] = None

    def update(self, buckets: Sequence[int]) -> float:
        cur = [int(c) for c in buckets[:NUM_BUCKETS]]
        prev = self._prev
        self._prev = cur
        if prev is None:
            delta = cur
        else:
            delta = [max(0, c - p) for c, p in zip(cur, prev)]
        total = sum(delta)
        if total == 0:
            return 0.0
        rank = max(1.0, 0.99 * total)
        cum = 0
        for i, c in enumerate(delta):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = 0 if i == 0 else (BASE_NS << (i - 1))
                hi = BASE_NS << i
                return (lo + (hi - lo) * (rank - cum) / c) / 1e6
            cum += c
        return float(BASE_NS << (NUM_BUCKETS - 1)) / 1e6  # pragma: no cover


class PolicyConfig(NamedTuple):
    """Tuning surface (mirrors the ``SENTINEL_CONTROL_*`` knobs)."""

    p99_hi_ms: float = 20.0         # backoff above this interval p99
    p99_lo_ms: float = 10.0         # recover below this; [lo,hi] = hold
    min_admit: float = 0.05         # shed floor (never black-hole)
    cooldown_ms: int = 2000         # per-action-key repeat bound
    degrade_rt_ms: float = 0.0      # per-resource RT tail bound (0 = off)
    queue_hi_frac: float = 0.75     # queue-depth overload trigger
    shed_backoff: float = 0.7       # multiplicative decrease factor
    shed_recover: float = 0.05      # additive increase step
    degrade_bad_ticks: int = 3      # consecutive bad RT ticks → open
    degrade_hold_ms: int = 5000     # open → half_open probe delay
    retune_budget_ms: int = 0       # overload flush reserve (0 = 2×base)
    retune_cap_frac: float = 0.5    # overload batch cap fraction


class _DegradeTracker:
    __slots__ = ("state", "bad", "since_ms")

    def __init__(self) -> None:
        self.state = DEG_CLOSE
        self.bad = 0
        self.since_ms = 0


class OverloadPolicy:
    """The decision core. ``observe()`` is the only entry point; it is
    deterministic in (config, observation sequence) — replaying the
    same telemetry yields the same action stream."""

    def __init__(self, cfg: PolicyConfig = PolicyConfig(), *,
                 base_budget_ms: int = 3, base_batch_cap: int = 256,
                 estimator_window_ms: int = 10_000):
        self.cfg = cfg
        self.base_budget_ms = max(0, int(base_budget_ms))
        self.base_batch_cap = max(1, int(base_batch_cap))
        self.admit_frac = 1.0
        self.degraded_batcher = False
        self.max_rate = WindowedFilter(estimator_window_ms, "max")
        self.min_rt_ms = WindowedFilter(estimator_window_ms, "min")
        self._last_ms: Dict[str, int] = {}      # action key → stamp
        self._trackers: Dict[str, _DegradeTracker] = {}

    # ---- cooldown ----------------------------------------------------

    def _ready(self, key: str, ts_ms: int) -> bool:
        last = self._last_ms.get(key)
        return last is None or ts_ms - last >= self.cfg.cooldown_ms

    def _stamp(self, key: str, ts_ms: int) -> None:
        self._last_ms[key] = ts_ms

    # ---- decision ----------------------------------------------------

    def _overload_retune(self) -> RetuneBatcher:
        budget = (self.cfg.retune_budget_ms
                  or max(1, 2 * self.base_budget_ms))
        cap = max(1, int(self.base_batch_cap * self.cfg.retune_cap_frac))
        return RetuneBatcher(budget, cap)

    def observe(self, obs: Observation) -> List:
        """One control tick: update the estimators, run the AIMD law and
        the per-resource degrade trackers; → actions to actuate (in
        emit order; may be empty — the hysteresis hold)."""
        cfg = self.cfg
        if obs.pass_per_s > 0:
            self.max_rate.update(obs.ts_ms, obs.pass_per_s)
        if obs.rt_avg_ms > 0:
            self.min_rt_ms.update(obs.ts_ms, obs.rt_avg_ms)
        actions: List = []
        queue_hot = (obs.queue_max > 0
                     and obs.queue_depth >= cfg.queue_hi_frac * obs.queue_max)
        overloaded = (obs.p99_ms > cfg.p99_hi_ms) or queue_hot
        healthy = (0.0 <= obs.p99_ms < cfg.p99_lo_ms) and not queue_hot
        if overloaded and self._ready("shed", obs.ts_ms):
            new = max(cfg.min_admit, self.admit_frac * cfg.shed_backoff)
            if new < self.admit_frac:
                self.admit_frac = new
                actions.append(ShedRate(new))
                self._stamp("shed", obs.ts_ms)
            if not self.degraded_batcher and self._ready("retune",
                                                         obs.ts_ms):
                self.degraded_batcher = True
                actions.append(self._overload_retune())
                self._stamp("retune", obs.ts_ms)
        elif healthy and self.admit_frac < 1.0 \
                and self._ready("shed", obs.ts_ms):
            new = min(1.0, self.admit_frac + cfg.shed_recover)
            self.admit_frac = new
            actions.append(ShedRate(new))
            self._stamp("shed", obs.ts_ms)
            if new >= 1.0 and self.degraded_batcher:
                # fully recovered: restore the operator's batcher tuning
                self.degraded_batcher = False
                actions.append(RetuneBatcher(self.base_budget_ms,
                                             self.base_batch_cap))
                self._stamp("retune", obs.ts_ms)
        # else: inside the [lo, hi] hysteresis band — hold
        if cfg.degrade_rt_ms > 0:
            actions.extend(self._degrade_actions(obs))
        return actions

    def _degrade_actions(self, obs: Observation) -> List[Degrade]:
        cfg = self.cfg
        out: List[Degrade] = []
        # tail-first: per-resource interval p99 when the histogram table
        # is live, hot-set mean RT otherwise
        signals = obs.resource_p99 or obs.resource_rt
        for resource, rt_ms in signals:
            tr = self._trackers.get(resource)
            if tr is None:
                tr = self._trackers[resource] = _DegradeTracker()
            bad = rt_ms > cfg.degrade_rt_ms
            if tr.state == DEG_CLOSE:
                tr.bad = tr.bad + 1 if bad else 0
                if tr.bad >= cfg.degrade_bad_ticks and self._ready(
                        f"degrade:{resource}", obs.ts_ms):
                    tr.state = DEG_OPEN
                    tr.since_ms = obs.ts_ms
                    tr.bad = 0
                    out.append(Degrade(resource, DEG_OPEN))
                    self._stamp(f"degrade:{resource}", obs.ts_ms)
            elif tr.state == DEG_OPEN:
                if obs.ts_ms - tr.since_ms >= cfg.degrade_hold_ms:
                    tr.state = DEG_HALF_OPEN
                    out.append(Degrade(resource, DEG_HALF_OPEN))
            elif rt_ms > 0:                     # HALF_OPEN, probe landed
                if bad:
                    tr.state = DEG_OPEN
                    tr.since_ms = obs.ts_ms
                    out.append(Degrade(resource, DEG_OPEN))
                else:
                    tr.state = DEG_CLOSE
                    tr.bad = 0
                    out.append(Degrade(resource, DEG_CLOSE))
        return out

    # ---- read surface ------------------------------------------------

    def snapshot(self) -> Dict:
        return {
            "admit_frac": round(self.admit_frac, 4),
            "degraded_batcher": self.degraded_batcher,
            "max_rate": self.max_rate.value,
            "min_rt_ms": self.min_rt_ms.value,
            "degrade": {r: t.state for r, t in self._trackers.items()
                        if t.state != DEG_CLOSE or t.bad},
        }
