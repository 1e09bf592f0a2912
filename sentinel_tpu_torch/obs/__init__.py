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
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

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
    """A ``torch.profiler.record_function`` context: names the enclosed
    dispatch in profiler timelines."""
    import torch
    return torch.profiler.record_function(name)


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
]
