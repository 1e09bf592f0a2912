"""Runtime self-telemetry: spans, decision counters, latency histograms,
block-event log (docs/OBSERVABILITY.md).

The port's copy of ``sentinel_tpu/obs/__init__.py``. The runtime owns one
:class:`RuntimeObs` (``Sentinel.obs``) and guards every instrumentation
site with its single ``enabled`` flag, so the dispatch path pays one
attribute check when observability is off. Everything here is host-side:
no device work, no background threads — :meth:`RuntimeObs.close` is a
pure state transition and is called by ``Sentinel.close()``.

Env knobs (read at ``RuntimeObs`` construction), the reference's names:

* ``SENTINEL_OBS_DISABLE`` — ``1``/``true`` turns all self-telemetry
  off (spans, counters, histograms, block events);
* ``SENTINEL_TRACE_SAMPLE`` — span/block-event sampling rate in
  ``[0, 1]`` (default 1.0 = every dispatch eligible; rendered as a
  deterministic stride, see obs/spans.py);
* ``SENTINEL_FLIGHT_DISABLE`` / ``SENTINEL_FLIGHT_WINDOW_MS`` /
  ``SENTINEL_FLIGHT_P99_MS`` / ``SENTINEL_FLIGHT_BLOCK_BURST`` — the
  SLO flight recorder (obs/flight.py).

:meth:`RuntimeObs.annotate` names a dispatch in ``torch.profiler``
timelines (``torch.profiler.record_function``) where the reference uses
``jax.profiler.TraceAnnotation``; the names are the reference's.
:func:`trace_annotation` opens such a range only while a torch profiler
collects (one module-attribute read otherwise), and is the one place
that decides it: ``annotate``, the engine step's slot ranges
(``engine.*``, no ring entry) and :meth:`RuntimeObs.span` go through it.

:meth:`RuntimeObs.span` opens a span that the ring records when it
closes and that, while a profiler collects, is also a range of the same
name (``ranged=False`` leaves the range out): on the profiler's clock,
beside the kernels it launched.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from sentinel_tpu_torch.obs import counters as counters_mod
from sentinel_tpu_torch.obs.counters import CounterSet
from sentinel_tpu_torch.obs.eventlog import BlockEventLog
from sentinel_tpu_torch.obs.flight import FlightRecorder
from sentinel_tpu_torch.obs.hist import LogHistogram, bucket_bounds_ns
from sentinel_tpu_torch.obs.spans import SpanRecorder

OBS_DISABLE_ENV = "SENTINEL_OBS_DISABLE"
TRACE_SAMPLE_ENV = "SENTINEL_TRACE_SAMPLE"

_NULL_CTX = contextlib.nullcontext()


def obs_disabled() -> bool:
    return os.environ.get(OBS_DISABLE_ENV, "").lower() in (
        "1", "true", "on", "yes")


def trace_sample_rate() -> float:
    raw = os.environ.get(TRACE_SAMPLE_ENV, "")
    if not raw:
        return 1.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 1.0


def trace_annotation(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    torch profiler collects, else a shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_CTX
    return torch.profiler.record_function(name)


class Span:
    """One open span of :meth:`RuntimeObs.span`. Closing it (``with`` or
    :meth:`close`, once) records ``(trace, name, start, end, n, note)``
    into the thread's ring as :meth:`SpanRecorder.record` does (a
    ``with`` block left by an exception before it closed records
    nothing); ``end`` is then its end time. ``ranged``: it is also a
    :func:`trace_annotation` range of the same name."""

    __slots__ = ("_rec", "trace", "name", "start", "end", "n", "note",
                 "_range")

    def __init__(self, rec: SpanRecorder, trace_id: int, name: str,
                 n: int, note: str, ranged: bool) -> None:
        self._rec = rec
        self.trace = trace_id
        self.name = name
        self.n = n
        self.note = note
        self.end = 0
        self._range = trace_annotation(name) if ranged else _NULL_CTX
        self._range.__enter__()
        self.start = rec.now_ns()

    def drop(self) -> None:
        """Record nothing into the ring at close."""
        self.trace = 0

    def close(self) -> None:
        if self._range is None:
            return
        self.end = self._rec.now_ns()
        self._range.__exit__(None, None, None)
        self._range = None
        self._rec.record(self.trace, self.name, self.start, self.end,
                         n=self.n, note=self.note)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if exc_type is not None:
            # a call that raised records no span
            self.trace = 0
        self.close()
        return False


class _NullSpan:
    """The span of a disabled bundle: records nothing."""

    __slots__ = ()

    def drop(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class RuntimeObs:
    """The per-``Sentinel`` telemetry bundle.

    Attributes the runtime's instrumentation sites touch directly:
    ``enabled`` (the one hot-path guard), ``spans``, ``counters``,
    ``hist_entry`` (entry→verdict ns), ``hist_dispatch``
    (dispatch→verdict-ready ns), ``hist_request`` (per-request
    ingest→verdict ns through a serving front end), ``block_events``."""

    def __init__(self, clock=None, enabled: Optional[bool] = None,
                 sample: Optional[float] = None) -> None:
        if sample is None:
            sample = trace_sample_rate()
        self.enabled = (not obs_disabled()) if enabled is None else enabled
        self.sample = sample
        self.clock = clock
        self.counters = CounterSet()
        # ring wrap is an operator signal, not a silent overwrite: each
        # span/link lost to a wrapped per-thread ring ticks the counter
        self.spans = SpanRecorder.for_clock(
            clock, sample=sample,
            on_wrap=lambda: self.counters.add(counters_mod.SPAN_RING_WRAP))
        self.hist_entry = LogHistogram()
        self.hist_dispatch = LogHistogram()
        self.hist_request = LogHistogram()
        self.block_events = BlockEventLog(sample=sample)
        # tail-based SLO capture (obs/flight.py); inert when the bundle
        # is disabled, individually removable via SENTINEL_FLIGHT_DISABLE
        self.flight = FlightRecorder(self)
        self._closed = False

    # ---- hot-path helpers -------------------------------------------

    def request_trace(self) -> int:
        """Trace id for one ingest request/flush: the flight recorder's
        always-on tier mints unconditionally (an SLO trigger must be able
        to pin ANY chain retroactively); otherwise the stride sampler
        decides. → 0 when telemetry is off."""
        if not self.enabled:
            return 0
        if self.flight.active:
            return self.spans.mint()
        return self.spans.maybe_trace()

    def span(self, trace_id: int, name: str, n: int = 0, note: str = "",
             detail: bool = False, ranged: bool = True):
        """Open a span on ``trace_id`` (:class:`Span`; a shared no-op one
        when disabled). A ``detail`` span splits a call's host time into
        its parts: the ring records it only on the real clock, since a
        virtual clock does not move inside a call."""
        if not self.enabled:
            return _NULL_SPAN
        if detail and not self.spans.real_time:
            trace_id = 0
        return Span(self.spans, trace_id, name, n, note, ranged)

    def annotate(self, name: str):
        """Profiler annotation for a dispatched step — a shared no-op
        context when disabled (one truthiness check, no allocation)."""
        if not self.enabled:
            return _NULL_CTX
        return trace_annotation(name)

    # ---- export surface ---------------------------------------------

    def payload(self, span_limit: int = 256,
                event_limit: int = 64) -> Dict:
        """The ``obs`` transport command / dashboard JSON body."""
        return {
            "enabled": self.enabled,
            "sample": self.sample,
            "counters": self.counters.snapshot(),
            "hist": {
                "entry_to_verdict": self.hist_entry.snapshot(),
                "dispatch_device": self.hist_dispatch.snapshot(),
                "request_to_verdict": self.hist_request.snapshot(),
                "bucket_bounds_ns": bucket_bounds_ns(),
            },
            "spans": self.spans.snapshot(limit=span_limit),
            "block_events": self.block_events.snapshot(limit=event_limit),
            "flight": {
                "active": self.flight.active,
                "window_ms": self.flight.window_ms,
                "pinned": self.flight.snapshot(),
            },
        }

    def flush(self) -> int:
        """Flush buffered block events + pinned flight chains to their
        writers (ridden by the metric timer's tick and by close)."""
        return self.block_events.flush() + self.flight.flush()

    def close(self) -> None:
        """Idempotent teardown: disable, drop span rings, flush + close
        the block-event and flight-recorder writers. Safe across
        repeated open/close."""
        if self._closed:
            return
        self._closed = True
        self.enabled = False
        self.flight.close()
        self.spans.close()
        self.block_events.close()


__all__ = [
    "OBS_DISABLE_ENV", "TRACE_SAMPLE_ENV", "RuntimeObs", "CounterSet",
    "LogHistogram", "SpanRecorder", "BlockEventLog", "FlightRecorder",
    "obs_disabled", "trace_sample_rate", "trace_annotation", "counters_mod",
    "Span",
]
