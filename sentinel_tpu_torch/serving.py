"""Depth-k dispatch pipelining over the runtime's nowait tier.

Port of ``sentinel_tpu/serving.py``. The synchronous serving loop —
``entry_batch_nowait(...).result()`` per step — pays the whole host
dispatch cost of every batch while the device waits, then idles the host
until the verdicts are home. :class:`DispatchPipeline` keeps up to
``depth`` batches in flight: ``submit`` prepares and enqueues batch N+1
while N still runs on the device, and settles the oldest only when the
window is full.

Ordering is the sequential loop's: the runtime advances engine state at
dispatch time under its own lock (submission order == state order), and
the pipeline settles handles strictly in submission order —
``PipelinedVerdicts.result()`` for batch N first settles every older
in-flight batch, so deferred host bookkeeping (pin release, block log,
breaker diffs) lands in dispatch order too.

Self-telemetry: ``pipeline.enqueue`` / ``pipeline.settle`` spans on
sampled batches, ``pipeline.depth`` (the in-flight count summed at each
enqueue), ``pipeline.stall`` (submits that had to settle the oldest batch
first) and ``pipeline.meshed_dispatch`` (submits over a row-sharded
runtime). Knob: ``SENTINEL_PIPELINE_DEPTH`` (default 2), which also
sizes the runtime's staging ring.

Over a ``"rows"`` mesh that spans processes a submit dispatches on the
caller's thread, in submission order, and a settle reads replicated
verdicts only: processes that submit the same batches in the same order
run the same collectives (the SPMD contract).

:class:`CadenceScheduler` is the one daemon that drives the runtime's
periodic services: the hot-set telemetry, the tiering ticker and, once a
``control.ControlLoop`` is attached, the overload controller. Its ticks
fall at each process's own wall-clock times, outside the SPMD contract
of a mesh over processes (in the JAX package too): there, call
``Sentinel.telemetry.tick()`` and the tiering ticker explicitly, in the
same order on every process.
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

from sentinel_tpu_torch.obs import counters as obs_keys
from sentinel_tpu_torch.runtime import (   # noqa: F401 - re-exported knob
    PIPELINE_DEPTH_ENV, PendingVerdicts, Sentinel, pipeline_depth,
)
from sentinel_tpu_torch.tiering.manager import (  # noqa: F401 - re-exported
    TIER_TICK_MS_ENV, tier_tick_ms,
)

_MISSING = object()


class PipelinedVerdicts:
    """Ticket for one submitted batch: ``result()`` settles every older
    in-flight batch first (strict in-order settle), then memoizes this
    batch's :class:`~sentinel_tpu_torch.engine.pipeline.Verdicts`. Safe
    to call out of submission order and more than once."""

    __slots__ = ("_pipe", "_seq", "_done", "_res")

    def __init__(self, pipe: "DispatchPipeline", seq: int):
        self._pipe = pipe
        self._seq = seq
        self._done = False
        self._res = None

    @property
    def seq(self) -> int:
        return self._seq

    def result(self):
        if not self._done:
            self._res = self._pipe._settle_through(self._seq)
            self._done = True
            self._pipe = None
        return self._res


class DispatchPipeline:
    """Depth-k dispatch window over one :class:`Sentinel`.

    Typical serving loop (rows interned once with
    ``Sentinel.intern_resources``)::

        pipe = DispatchPipeline(sentinel)          # depth from env, or pass
        tickets = collections.deque()
        for step_rows in traffic:
            tickets.append(pipe.submit(step_rows))
            if len(tickets) > pipe.depth:
                verdicts = tickets.popleft().result()
                ...
        pipe.flush()

    ``depth=1`` is the synchronous loop (every submit settles the
    previous batch). Submits serialize under the pipeline's lock; use one
    pipeline per dispatcher thread."""

    def __init__(self, sentinel: Sentinel, depth: Optional[int] = None,
                 on_settle=None):
        self._s = sentinel
        # a row-sharded runtime underneath: each submit also counts
        # pipeline.meshed_dispatch
        self._meshed = getattr(sentinel, "mesh", None) is not None
        if depth is None:
            # the engine's tuned-config resolution (Sentinel._tuned only
            # holds knobs whose env var is unset, so env still wins);
            # getattr: pipelines are also built over test doubles
            tuned = getattr(sentinel, "_tuned", None) or {}
            depth = tuned.get(PIPELINE_DEPTH_ENV, pipeline_depth())
        self.depth = max(1, int(depth))
        self._lock = threading.Lock()
        # (seq, PendingVerdicts, trace id) in submission order
        self._inflight: "collections.deque" = collections.deque()
        # seq → settled Verdicts awaiting its ticket's result()
        self._results: dict = {}
        self._next_seq = 0
        # on_settle(seq, verdicts): fired after EVERY settle (stall,
        # result() drain or flush), with the pipeline lock held — keep it
        # quick and never call back into this pipeline from it
        self._on_settle = on_settle

    # ---- submission --------------------------------------------------

    def submit(self, resources, **entry_kwargs) -> PipelinedVerdicts:
        """Dispatch one entry batch through
        :meth:`Sentinel.entry_batch_nowait` (its kwargs pass through:
        origins, acquire, prioritized, args_list, ...). ``trace_id``
        threads a caller's trace through the pipeline and the dispatch."""
        n = len(resources)
        trace_id = entry_kwargs.get("trace_id", 0)
        return self._submit(
            lambda: self._s.entry_batch_nowait(resources, **entry_kwargs),
            n, trace_id=trace_id)

    def submit_raw(self, *args, **kwargs) -> PipelinedVerdicts:
        """Dispatch through :meth:`Sentinel.decide_raw_nowait` (rows and
        ids resolved already)."""
        n = args[0].shape[0] if args else 0
        return self._submit(
            lambda: self._s.decide_raw_nowait(*args, **kwargs), n,
            trace_id=kwargs.get("trace_id", 0))

    def submit_fused(self, *args, **kwargs) -> PipelinedVerdicts:
        """Dispatch through :meth:`Sentinel.decide_and_exit_raw_nowait`:
        this step's decides and the previous step's completions in one
        engine step (``param_args`` puts the decides through the hot-param
        rules, resolved in the dispatch)."""
        n = args[0].shape[0] if args else 0
        return self._submit(
            lambda: self._s.decide_and_exit_raw_nowait(*args, **kwargs), n,
            trace_id=kwargs.get("trace_id", 0))

    def _submit(self, dispatch, n: int,
                trace_id: int = 0) -> PipelinedVerdicts:
        obs = self._s.obs
        obs_on = obs.enabled
        tr = (trace_id or obs.spans.maybe_trace()) if obs_on else 0
        with obs.span(tr, "pipeline.enqueue", n=n) as span:
            with self._lock:
                # make room BEFORE dispatching: settling the oldest here
                # (a stall) keeps at most `depth` batches in flight
                while len(self._inflight) >= self.depth:
                    if obs_on:
                        obs.counters.add(obs_keys.PIPE_STALL)
                    self._settle_oldest_locked()
                handle = dispatch()
                seq = self._next_seq
                self._next_seq += 1
                # the trace id rides the in-flight entry so the settle
                # span lands on the same chain as the enqueue span
                self._inflight.append((seq, handle, tr))
                if obs_on:
                    obs.counters.add(obs_keys.PIPE_DEPTH,
                                     len(self._inflight))
                    if self._meshed:
                        obs.counters.add(obs_keys.PIPE_MESHED)
            if tr:
                span.note = f"seq={seq}"
        return PipelinedVerdicts(self, seq)

    # ---- settlement --------------------------------------------------

    def _settle_oldest_locked(self) -> None:
        seq, handle, tr = self._inflight.popleft()
        obs = self._s.obs
        if not obs.enabled:
            tr = 0
        with obs.span(tr, "pipeline.settle",
                      note=f"seq={seq}" if tr else ""):
            self._results[seq] = handle.result()
        if self._on_settle is not None:
            self._on_settle(seq, self._results[seq])

    def _settle_through(self, seq: int):
        with self._lock:
            res = self._results.pop(seq, _MISSING)
            if res is not _MISSING:
                return res
            while self._inflight and self._inflight[0][0] <= seq:
                self._settle_oldest_locked()
            res = self._results.pop(seq, _MISSING)
        if res is _MISSING:
            raise KeyError(f"unknown or already-consumed batch seq {seq}")
        return res

    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def flush(self) -> None:
        """Settle every in-flight batch (their verdicts stay claimable
        through the tickets)."""
        with self._lock:
            while self._inflight:
                self._settle_oldest_locked()

    def __enter__(self) -> "DispatchPipeline":
        return self

    def __exit__(self, *exc) -> bool:
        self.flush()
        return False


class CadenceScheduler:
    """One daemon thread for the runtime's periodic services.

    Each pass (:meth:`poll`) self-dispatches a ``tick()`` of a service
    whose armed cadence has gone stale (:data:`IDLE_FACTOR` × its interval
    without a tick: no serving dispatch carried one) and drains its queued
    readbacks off the engine lock. The services are ``sn.telemetry``,
    ``sn.tiering`` and ``sn.control``; a disabled service is skipped, and
    so is the controller until a ``control.ControlLoop`` attaches itself
    as ``sn.control``. Armed, the telemetry and tiering ticks ride the
    fused serving dispatch (``SENTINEL_SINGLE_DISPATCH``), so under load
    the scheduler only drains.

    ``poll()`` is callable directly in tests; ``start``/``stop`` are
    idempotent and ``stop`` is registered with
    ``Sentinel.register_shutdown``."""

    #: a carry slot counts as missed — and the scheduler self-dispatches —
    #: after this many armed intervals without a tick
    IDLE_FACTOR = 1.5

    def __init__(self, sentinel: Sentinel,
                 telemetry_interval_sec: float = 1.0,
                 tiering_interval_sec: Optional[float] = None):
        self._s = sentinel
        if tiering_interval_sec is None:
            tiering_interval_sec = tier_tick_ms() / 1000.0
        self._tel_ms = max(1, int(telemetry_interval_sec * 1000))
        self._tier_ms = max(1, int(tiering_interval_sec * 1000))
        # drain at twice the fastest cadence so carried readbacks land
        # with at most half an interval of extra latency
        self._poll_s = max(0.02, min(self._tel_ms, self._tier_ms) / 2000.0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = getattr(sentinel, "register_shutdown", None)
        if reg is not None:
            reg(self)

    def _carried(self):
        """→ ``[(service, interval ms)]`` of the carried services the
        runtime has."""
        out = []
        for name, ms in (("telemetry", self._tel_ms),
                         ("tiering", self._tier_ms)):
            svc = getattr(self._s, name, None)
            if svc is not None:
                out.append((svc, ms))
        return out

    def poll(self) -> int:
        """One scheduler pass: self-dispatch any stale service's tick,
        then drain it; → entries drained."""
        sn = self._s
        n = 0
        for svc, interval_ms in self._carried():
            if not svc.enabled:
                continue
            now = sn.clock.now_ms()
            if now - svc.last_tick_ms() >= interval_ms * self.IDLE_FACTOR:
                svc.tick()
            n += svc.drain()
        # the overload controller rides the same daemon; its tick is
        # never carried, so the cadence check is exact
        ctl = getattr(sn, "control", None)
        if ctl is not None and ctl.enabled:
            now = sn.clock.now_ms()
            if now - ctl.last_tick_ms() >= ctl.interval_ms:
                ctl.tick()
            n += ctl.drain()
        return n

    def start(self) -> None:
        """Arm the carried cadences and start the daemon (idempotent)."""
        if self._thread is not None:
            return
        for svc, interval_ms in self._carried():
            svc.arm_carry(interval_ms)
        self._stop.clear()

        def loop():
            while not self._stop.wait(self._poll_s):
                try:
                    self.poll()
                except Exception:  # pragma: no cover — keep daemon alive
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="sentinel-cadence")
        self._thread.start()

    def stop(self) -> None:
        """Disarm the carries and join the daemon (idempotent; the
        services' own registered stops do their final drains)."""
        for svc, _ms in self._carried():
            svc.disarm_carry()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
