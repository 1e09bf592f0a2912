"""Deadline-driven adaptive batching: the async ingest tier.

Port of ``sentinel_tpu/frontend/batcher.py``. Individual requests
(resource, count, priority, origin, deadline) arrive on an asyncio loop,
coalesce into device batches, and dispatch at **min(B_max,
oldest-deadline)**: a batch is cut the moment it fills, OR the moment the
head-of-queue request's latency budget is about to expire, OR when the
arrival stream goes idle. Verdicts fan back out to per-request futures in
dispatch order, equal to a sequential ``entry_batch`` loop over the same
batches (``tests/test_torch_frontend.py``).

Two layers:

* :class:`IngestQueue` — the pure policy core: holds pending requests,
  answers "should this batch flush NOW, and why" (``flush_reason``) and
  "when must the loop wake next" (``fire_at_ms``). No asyncio, no engine;
  driven by explicit ``now_ms`` values.
* :class:`AdaptiveBatcher` — the asyncio overlay: an ingest loop that
  waits on ``min(time-to-deadline, idle-gap)``, a dispatch step that rides
  :class:`~sentinel_tpu_torch.serving.DispatchPipeline` (depth-k in-flight
  window, in-order settle), and a settle loop that fans verdicts back to
  futures. The dispatch and the verdict readback (``.result()``, the only
  wait on the device) run in ``asyncio.to_thread`` workers, so the event
  loop never blocks on the device; a depth semaphore released from the
  pipeline's ``on_settle`` hook keeps at most ``depth`` batches in flight
  without ``submit`` ever stalling inside a worker.

Resource names intern once into an instance row cache and flushes
dispatch int32 row arrays.

Backpressure: at most ``queue_max`` requests may be pending + in flight;
past that ``submit`` raises :class:`IngestOverload` at once and
``frontend.shed`` ticks.

Shutdown: the batcher registers with ``Sentinel.register_shutdown``, so
``Sentinel.close()`` tears it down — pending futures fail with
:class:`FrontendClosed`, already-dispatched work settles through
``DispatchPipeline.flush()``.

Env knobs (read at construction; constructor kwargs override):

* ``SENTINEL_FRONTEND_BATCH`` — B_max, default 256;
* ``SENTINEL_FRONTEND_DEADLINE_MS`` — default per-request budget, 25;
* ``SENTINEL_FRONTEND_BUDGET_MS`` — dispatch+device reserve subtracted
  from each deadline when computing the fire point, default 3;
* ``SENTINEL_FRONTEND_IDLE_MS`` — arrival gap after which a partial
  batch flushes early, default 1.0 (0 = flush whenever ingest drains);
* ``SENTINEL_FRONTEND_QUEUE`` — backpressure bound, default 8·B_max.

Self-telemetry: counters ``frontend.enqueue``, ``frontend.queue_depth``
(pending depth summed at each enqueue), ``frontend.shed``,
``frontend.flush_reason.{full,deadline,idle}``; spans
``frontend.enqueue`` / ``frontend.flush`` / ``frontend.settle`` and the
request→batch→request links of request tracing; per-request
ingest→verdict ns in ``obs.hist_request``; the flight recorder's
``shed`` and ``deadline_miss`` triggers.
"""

from __future__ import annotations

import asyncio
import collections
import os
import threading
import zlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from sentinel_tpu_torch.core import errors as err_mod
from sentinel_tpu_torch.obs import counters as obs_keys
from sentinel_tpu_torch.serving import DispatchPipeline

FRONTEND_BATCH_ENV = "SENTINEL_FRONTEND_BATCH"
FRONTEND_DEADLINE_ENV = "SENTINEL_FRONTEND_DEADLINE_MS"
FRONTEND_BUDGET_ENV = "SENTINEL_FRONTEND_BUDGET_MS"
FRONTEND_IDLE_ENV = "SENTINEL_FRONTEND_IDLE_MS"
FRONTEND_QUEUE_ENV = "SENTINEL_FRONTEND_QUEUE"

FLUSH_FULL = "full"
FLUSH_DEADLINE = "deadline"
FLUSH_IDLE = "idle"

_FLUSH_KEY = {
    FLUSH_FULL: obs_keys.FE_FLUSH_FULL,
    FLUSH_DEADLINE: obs_keys.FE_FLUSH_DEADLINE,
    FLUSH_IDLE: obs_keys.FE_FLUSH_IDLE,
}


def _env_num(name: str, default, lo, hi, cast=int):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return min(hi, max(lo, cast(raw)))
    except ValueError:
        return default


def frontend_batch_max(default: int = 256) -> int:
    """``SENTINEL_FRONTEND_BATCH``, clamped to [1, 65536]."""
    return _env_num(FRONTEND_BATCH_ENV, default, 1, 1 << 16)


def frontend_deadline_ms(default: int = 25) -> int:
    """``SENTINEL_FRONTEND_DEADLINE_MS``, clamped to [1, 60000]."""
    return _env_num(FRONTEND_DEADLINE_ENV, default, 1, 60_000)


def frontend_budget_ms(default: int = 3) -> int:
    """``SENTINEL_FRONTEND_BUDGET_MS``, clamped to [0, 10000]."""
    return _env_num(FRONTEND_BUDGET_ENV, default, 0, 10_000)


def frontend_idle_ms(default: float = 1.0) -> float:
    """``SENTINEL_FRONTEND_IDLE_MS``, clamped to [0, 1000]."""
    return _env_num(FRONTEND_IDLE_ENV, default, 0.0, 1000.0, cast=float)


def frontend_queue_max(batch_max: int) -> int:
    """``SENTINEL_FRONTEND_QUEUE``, default 8·B_max, clamped ≥ B_max."""
    return _env_num(FRONTEND_QUEUE_ENV, 8 * batch_max, batch_max, 1 << 22)


class IngestOverload(RuntimeError):
    """Backpressure shed: the ingest queue is at ``queue_max`` — the
    request was rejected WITHOUT being enqueued (map to HTTP 503)."""


class FrontendClosed(RuntimeError):
    """The batcher (or its Sentinel) was closed while this request was
    still pending; no verdict was produced."""


class RequestVerdict(NamedTuple):
    """Per-request verdict fanned out of a batch decision."""

    allow: bool
    reason: int          # int8 verdict code (0 = pass)
    wait_ms: int         # PriorityWait / pacing hint
    latency_ms: float    # ingest → verdict, this request
    trace_id: int = 0    # request-scoped trace id (0 = not traced)

    @property
    def reason_name(self) -> str:
        return "" if self.allow else err_mod.exception_name_for(self.reason)


class _Pending:
    __slots__ = ("resource", "count", "prioritized", "origin",
                 "deadline_ms", "t0_ns", "future", "trace_id")

    def __init__(self, resource, count, prioritized, origin, deadline_ms,
                 t0_ns, future, trace_id=0):
        self.resource = resource
        self.count = count
        self.prioritized = prioritized
        self.origin = origin
        self.deadline_ms = deadline_ms      # ABSOLUTE fire-by time
        self.t0_ns = t0_ns
        self.future = future
        self.trace_id = trace_id            # request-scoped trace (0=off)


class IngestQueue:
    """The pure flush policy: dispatch at ``min(B_max, oldest-deadline)``.

    Holds pending requests FIFO and answers, for an explicit ``now_ms``:

    * :meth:`flush_reason` — ``"full"`` when ≥ ``batch_max`` requests
      are pending; ``"deadline"`` when the oldest pending deadline
      (minus the ``budget_ms`` dispatch+device reserve) has arrived;
      ``"idle"`` when the caller reports the arrival stream went idle
      (no new request within ``idle_ms``) and anything is pending;
      ``None`` otherwise (keep coalescing).
    * :meth:`fire_at_ms` — the absolute time the deadline rule will
      trigger (the loop's next wake-up bound).

    No asyncio, no engine — tests drive it directly under the virtual
    clock."""

    def __init__(self, batch_max: int, budget_ms: int = 0,
                 queue_max: Optional[int] = None):
        self.batch_max = max(1, int(batch_max))
        self.budget_ms = max(0, int(budget_ms))
        self.queue_max = (self.batch_max * 8 if queue_max is None
                          else max(1, int(queue_max)))
        self._q: "collections.deque[_Pending]" = collections.deque()
        self._min_deadline: Optional[int] = None
        # controller-settable admission gate: fraction of arriving
        # requests admitted BEFORE they join a batch. 1.0 = the gate is
        # wide open and admitted() takes the zero-state early return, so
        # an idle controller leaves the request stream (and every
        # downstream verdict) unchanged.
        self.admit_frac = 1.0
        self.admit_seed = 0
        self._admit_idx = 0

    def set_admission(self, frac: float, seed: int = 0) -> None:
        """Controller actuation: admit only ``frac`` of arriving
        requests. Deterministic — the drop pattern is a pure function of
        ``(seed, arrival index, resource)``, so a replay of the same
        request stream with the same seed sheds the same requests (the
        property the gate's replayability check rides on)."""
        self.admit_frac = min(1.0, max(0.0, float(frac)))
        self.admit_seed = int(seed) & 0xFFFFFFFF
        self._admit_idx = 0

    def admitted(self, resource: str) -> bool:
        """One admission draw (consumes one arrival index when the gate
        is engaged; free when wide open)."""
        if self.admit_frac >= 1.0:
            return True
        idx = self._admit_idx
        self._admit_idx = idx + 1
        mix = (self.admit_seed * 0x9E3779B1 + idx) & 0xFFFFFFFF
        h = zlib.crc32(resource.encode("utf-8", "replace"), mix)
        return (h & 0xFFFFFF) / float(1 << 24) < self.admit_frac

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.batch_max

    def would_shed(self, inflight: int = 0) -> bool:
        return len(self._q) + inflight >= self.queue_max

    def add(self, req: _Pending) -> None:
        self._q.append(req)
        if self._min_deadline is None or req.deadline_ms < self._min_deadline:
            self._min_deadline = req.deadline_ms

    def fire_at_ms(self) -> Optional[int]:
        """Absolute ms at which the deadline rule fires (oldest pending
        deadline minus the dispatch budget); None when empty."""
        if self._min_deadline is None:
            return None
        return self._min_deadline - self.budget_ms

    def flush_reason(self, now_ms: int, idle: bool = False) -> Optional[str]:
        if not self._q:
            return None
        if len(self._q) >= self.batch_max:
            return FLUSH_FULL
        fire = self.fire_at_ms()
        if fire is not None and now_ms >= fire:
            return FLUSH_DEADLINE
        if idle:
            return FLUSH_IDLE
        return None

    def take(self) -> List[_Pending]:
        """Pop up to ``batch_max`` requests in arrival order."""
        n = min(len(self._q), self.batch_max)
        out = [self._q.popleft() for _ in range(n)]
        self._min_deadline = (min(r.deadline_ms for r in self._q)
                              if self._q else None)
        return out

    def take_all(self) -> List[_Pending]:
        out = list(self._q)
        self._q.clear()
        self._min_deadline = None
        return out


class AdaptiveBatcher:
    """Asyncio ingest front end over one :class:`Sentinel`.

    In-process async client API (also what frontend/server.py's HTTP
    handlers call)::

        batcher = sph.frontend()            # or AdaptiveBatcher(sph)
        verdict = await batcher.submit("api", count=1, origin="app-a")
        if verdict.allow: ...

    One batcher per event loop; the ingest/settle tasks start lazily on
    the loop of the first ``submit`` and die with ``close()``. All
    engine round-trips run in worker threads (``asyncio.to_thread``) —
    the loop thread never blocks on a device readback."""

    def __init__(self, sentinel, *, batch_max: Optional[int] = None,
                 deadline_ms: Optional[int] = None,
                 budget_ms: Optional[int] = None,
                 idle_ms: Optional[float] = None,
                 queue_max: Optional[int] = None,
                 depth: Optional[int] = None,
                 record_flushes: bool = False):
        self._s = sentinel
        self.batch_max = (frontend_batch_max() if batch_max is None
                          else max(1, int(batch_max)))
        self.deadline_ms = (frontend_deadline_ms() if deadline_ms is None
                            else max(1, int(deadline_ms)))
        self.budget_ms = (frontend_budget_ms() if budget_ms is None
                          else max(0, int(budget_ms)))
        self.idle_ms = (frontend_idle_ms() if idle_ms is None
                        else max(0.0, float(idle_ms)))
        self.queue = IngestQueue(
            self.batch_max, self.budget_ms,
            frontend_queue_max(self.batch_max) if queue_max is None
            else queue_max)
        self._pipe = DispatchPipeline(sentinel, depth=depth,
                                      on_settle=self._pipe_settled)
        self.depth = self._pipe.depth
        # name → interned row; grows to at most the resource universe,
        # same staleness class as any name→row cache (see
        # entry_batch_nowait). With tiering (where the runtime has it)
        # demotions prune their entries, so a demoted key's next request
        # re-interns — the promotion trigger.
        self._rows: Dict[str, int] = {}
        tiering = getattr(sentinel, "tiering", None)
        if tiering is not None and tiering.enabled:
            tiering.add_demote_listener(self._on_demoted)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake: Optional[asyncio.Event] = None
        self._slots: Optional[asyncio.Semaphore] = None
        self._settle_q: Optional[asyncio.Queue] = None
        self._run_task = None
        self._settle_task = None
        self._inflight = 0              # requests dispatched, not settled
        self._inflight_reqs: "collections.deque" = collections.deque()
        self._closed = False
        self._close_lock = threading.Lock()
        self.flush_log: List[dict] = [] if record_flushes else None
        reg = getattr(sentinel, "register_shutdown", None)
        if reg is not None:
            reg(self)

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------

    async def submit(self, resource: str, *, count: int = 1,
                     prioritized: bool = False, origin: str = "",
                     deadline_ms: Optional[int] = None) -> RequestVerdict:
        """Enqueue one request; resolves when its batch's verdicts land.

        ``deadline_ms`` is this request's latency budget RELATIVE to now
        (default ``SENTINEL_FRONTEND_DEADLINE_MS``); the batch it joins
        dispatches no later than ``deadline - budget_ms``. Raises
        :class:`IngestOverload` at the backpressure bound and
        :class:`FrontendClosed` after shutdown."""
        if self._closed:
            raise FrontendClosed("ingest front end is closed")
        self._ensure_started()
        obs = self._s.obs
        obs_on = obs.enabled
        # request-scoped trace id: the flight recorder's always-on tier
        # mints for EVERY request (an SLO trigger must be able to pin any
        # chain retroactively); without it the stride sampler decides
        tr = obs.request_trace() if obs_on else 0
        t0 = obs.spans.now_ns() if obs_on else 0
        if not self.queue.admitted(resource):
            # controller shed: dropped BEFORE the batch forms, so the
            # device never sees the request (the whole point — overload
            # relief must not cost a dispatch). The triggering action
            # already pinned a flight chain; per-request drops only count.
            if obs_on:
                obs.counters.add(obs_keys.CONTROL_DROPPED)
                obs.counters.add(obs_keys.FE_SHED)
            raise IngestOverload(
                f"admission controller shedding "
                f"(frac={self.queue.admit_frac:.3f}); request shed")
        if self.queue.would_shed(self._inflight):
            if obs_on:
                obs.counters.add(obs_keys.FE_SHED)
                obs.flight.trigger("shed", note=f"resource={resource}")
            raise IngestOverload(
                f"ingest queue at bound ({self.queue.queue_max} pending"
                f"+inflight); request shed")
        now = self._s.clock.now_ms()
        budget = self.deadline_ms if deadline_ms is None else max(
            1, int(deadline_ms))
        req = _Pending(resource, int(count), bool(prioritized), origin,
                       now + budget, t0 if obs_on else 0,
                       self._loop.create_future(), tr)
        self.queue.add(req)
        if obs_on:
            obs.counters.add(obs_keys.FE_ENQUEUE)
            obs.counters.add(obs_keys.FE_QUEUE_DEPTH, len(self.queue))
            if tr:
                obs.spans.record(tr, "frontend.enqueue", t0,
                                 obs.spans.now_ns(),
                                 note=f"depth={len(self.queue)}")
        self._wake.set()
        return await req.future

    async def drain(self) -> None:
        """Flush everything pending (idle-reason batches) and wait until
        every dispatched batch has settled and fanned out."""
        self._ensure_started()
        while len(self.queue) or self._inflight:
            if len(self.queue):
                await self._flush(FLUSH_IDLE)
            else:
                await asyncio.sleep(0.001)

    @property
    def pending(self) -> int:
        """Requests accepted but not yet fanned out (queued + in flight)."""
        return len(self.queue) + self._inflight

    def retune(self, budget_ms: Optional[int] = None,
               batch_cap: Optional[int] = None) -> None:
        """Controller actuation: hot-swap the flush-deadline reserve and
        the batch cap ONLINE. Pure host-side policy state — no retrace,
        no new engine geometry (padded dispatch widths are chosen per
        flush, exactly as before). Callable from any thread; the ingest
        loop picks the new values up on its next wake. A ``batch_cap``
        above the construction-time ``batch_max`` is clamped: the
        controller may only trade throughput for latency, never exceed
        the operator's provisioned batch width."""
        if budget_ms is not None:
            self.budget_ms = max(0, int(budget_ms))
            self.queue.budget_ms = self.budget_ms
        if batch_cap is not None:
            cap = min(self.batch_max, max(1, int(batch_cap)))
            self.queue.batch_max = cap
        loop, wake = self._loop, self._wake
        if loop is not None and wake is not None and not loop.is_closed():
            loop.call_soon_threadsafe(wake.set)

    # ------------------------------------------------------------------
    # ingest loop
    # ------------------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._run_task is not None:
            return
        loop = asyncio.get_running_loop()
        self._loop = loop
        self._wake = asyncio.Event()
        self._slots = asyncio.Semaphore(self.depth)
        self._flush_lock = asyncio.Lock()
        self._settle_q = asyncio.Queue()
        self._run_task = loop.create_task(self._run())
        self._settle_task = loop.create_task(self._settle_loop())

    async def _run(self) -> None:
        """The adaptive ingest loop: coalesce until full / deadline /
        idle, then flush. Waits are bounded by the EARLIER of the
        oldest pending deadline and the idle gap."""
        while not self._closed:
            if not len(self.queue):
                self._wake.clear()
                if not len(self.queue):        # re-check after clear
                    await self._wake.wait()
                continue
            now = self._s.clock.now_ms()
            reason = self.queue.flush_reason(now)
            if reason is None:
                fire = self.queue.fire_at_ms()
                # bounded by the EARLIER of deadline and idle gap; an
                # idle_ms of 0 flushes as soon as ingest drains (one
                # loop pass of coalescing, minimum latency)
                wait_ms = min(max(0.0, float(fire - now)), self.idle_ms)
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           wait_ms / 1000.0)
                    continue                    # new arrival: re-coalesce
                except asyncio.TimeoutError:
                    now = self._s.clock.now_ms()
                    reason = self.queue.flush_reason(now, idle=True)
                    if reason is None:          # raced an empty queue
                        continue
            await self._flush(reason)

    async def _flush(self, reason: str) -> None:
        # serialized: the ingest loop and drain() may both flush, and
        # pipeline submission order IS engine-state order — interleaved
        # dispatches would make batch order (hence QPS depletion order)
        # nondeterministic
        async with self._flush_lock:
            await self._flush_locked(reason)

    async def _flush_locked(self, reason: str) -> None:
        reqs = self.queue.take()
        if not reqs:
            return
        obs = self._s.obs
        obs_on = obs.enabled
        tr = obs.request_trace() if obs_on else 0
        t0 = obs.spans.now_ns() if tr else 0
        if obs_on:
            obs.counters.add(_FLUSH_KEY[reason])
        if tr:
            # fan-in: every request trace joins this batch's trace (the
            # causal edges chain(request_id) walks to reach the
            # pipeline/device spans)
            for r in reqs:
                if r.trace_id:
                    obs.spans.link(r.trace_id, tr, "flush")
        if self.flush_log is not None:
            self.flush_log.append({
                "reason": reason,
                "resources": [r.resource for r in reqs],
                "counts": [r.count for r in reqs],
                "prioritized": [r.prioritized for r in reqs],
                "origins": [r.origin for r in reqs],
            })
        self._inflight += len(reqs)
        # free pipeline slot BEFORE dispatching: the semaphore (released
        # from the pipeline's on_settle hook) bounds in-flight batches at
        # `depth` without DispatchPipeline.submit ever stalling — a stall
        # would block a worker thread on a device readback mid-dispatch
        await self._slots.acquire()
        ticket = await asyncio.to_thread(self._dispatch, reqs, tr)
        if tr:
            obs.spans.record(tr, "frontend.flush", t0, obs.spans.now_ns(),
                             n=len(reqs), note=reason)
        self._inflight_reqs.append(reqs)
        await self._settle_q.put((ticket, reqs, tr))

    def _dispatch(self, reqs: List[_Pending], trace_id: int = 0):
        """Host prep + device dispatch for one batch (worker thread).
        Rows are pre-interned through the instance cache; misses intern
        once via the vectorized registry path. ``trace_id`` (the batch
        trace) threads through the pipeline seq into the device spans."""
        n = len(reqs)
        rows = np.empty(n, np.int32)
        cache = self._rows
        miss_idx: List[int] = []
        for i, r in enumerate(reqs):
            row = cache.get(r.resource)
            if row is None:
                miss_idx.append(i)
            else:
                rows[i] = row
        if miss_idx:
            names = [reqs[i].resource for i in miss_idx]
            fresh = self._s.intern_resources(names)
            for i, row in zip(miss_idx, fresh):
                cache[reqs[i].resource] = int(row)
                rows[i] = row
        if n > len(miss_idx):
            # cache hits are resident by construction (demotion pruned);
            # count them so the tier hit rate covers the cached path too
            tiering = getattr(self._s, "tiering", None)
            if tiering is not None:
                tiering.note_hot_hits(n - len(miss_idx))
        acquire = np.fromiter((r.count for r in reqs), np.int32, count=n)
        prio = np.fromiter((r.prioritized for r in reqs), np.bool_, count=n)
        origins = ([r.origin for r in reqs]
                   if any(r.origin for r in reqs) else None)
        return self._pipe.submit(rows, acquire=acquire,
                                 prioritized=prio, origins=origins,
                                 trace_id=trace_id)

    # ------------------------------------------------------------------
    # settle / fan-out
    # ------------------------------------------------------------------

    def _on_demoted(self, names) -> None:
        """Tiering demote listener (engine lock held — O(names) only):
        drop demoted keys from the name→row cache so their next request
        misses, re-interns, and triggers promotion."""
        cache = self._rows
        for name in names:
            cache.pop(name, None)

    def _pipe_settled(self, seq: int, verdicts) -> None:
        """DispatchPipeline on_settle hook (any settling thread, pipeline
        lock held): release one depth slot back to the ingest loop."""
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(self._slots.release)

    async def _settle_loop(self) -> None:
        """Settles flushed batches strictly in dispatch order and fans
        each batch's verdicts out to its request futures."""
        obs = self._s.obs
        while True:
            ticket, reqs, batch_tr = await self._settle_q.get()
            verdicts = await asyncio.to_thread(ticket.result)
            if self._inflight_reqs and self._inflight_reqs[0] is reqs:
                self._inflight_reqs.popleft()
            self._inflight -= len(reqs)
            obs_on = obs.enabled
            t_end = obs.spans.now_ns() if obs_on else 0
            now_ms = self._s.clock.now_ms() if obs_on else 0
            worst = None              # worst deadline overrun this batch
            allow = np.asarray(verdicts.allow)
            reason = np.asarray(verdicts.reason)
            wait = np.asarray(verdicts.wait_ms)
            for i, r in enumerate(reqs):
                lat_ns = (t_end - r.t0_ns) if obs_on else 0
                if obs_on:
                    obs.hist_request.record(lat_ns)
                    if r.trace_id:
                        # fan-out: the batch settles THIS request (the
                        # flow arrow back), then the request's terminal
                        # span closes its chain
                        if batch_tr:
                            obs.spans.link(batch_tr, r.trace_id, "verdict")
                        obs.spans.record(r.trace_id, "frontend.settle",
                                         r.t0_ns, t_end, n=1)
                    if now_ms > r.deadline_ms and (
                            worst is None or worst[1] < now_ms
                            - r.deadline_ms):
                        worst = (r.trace_id, now_ms - r.deadline_ms)
                if not r.future.done():
                    r.future.set_result(RequestVerdict(
                        bool(allow[i]), int(reason[i]), int(wait[i]),
                        lat_ns / 1e6, r.trace_id))
            if obs_on:
                if worst is not None:
                    # SLO trigger: pin the worst-overrun request's chain
                    # (rate-limited per kind inside the recorder)
                    obs.flight.trigger("deadline_miss", root=worst[0],
                                       note=f"overrun_ms={worst[1]}",
                                       worst_ms=worst[1])
                obs.flight.note_requests(len(reqs))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def close(self) -> None:
        """Idempotent; callable from any thread (``Sentinel.close()``
        runs it via the shutdown registry). Pending futures fail with
        :class:`FrontendClosed`; device work already dispatched settles
        through the pipeline so engine bookkeeping stays consistent."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                on_loop = asyncio.get_running_loop() is loop
            except RuntimeError:
                on_loop = False
            if on_loop:
                self._shutdown_on_loop()
            else:
                loop.call_soon_threadsafe(self._shutdown_on_loop)
        # settle every dispatched batch (the settle task is dying with
        # the loop) — blocking, but terminal; bookkeeping must land
        self._pipe.flush()

    def _shutdown_on_loop(self) -> None:
        for task in (self._run_task, self._settle_task):
            if task is not None:
                task.cancel()
        exc = FrontendClosed("ingest front end closed before verdict")
        dropped = self.queue.take_all()
        for batch in list(self._inflight_reqs):
            dropped.extend(batch)
        self._inflight_reqs.clear()
        self._inflight = 0
        for req in dropped:
            if not req.future.done():
                req.future.set_exception(exc)
            elif not req.future.cancelled():
                req.future.exception()      # mark retrieved either way
