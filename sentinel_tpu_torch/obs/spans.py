"""Lock-free per-thread ring-buffer span recorder (Dapper-style sampled
tracing of the batch lifecycle).

Every dispatching thread appends finished spans into its OWN fixed-size
ring — appends are plain ``list.append`` / index stores (GIL-atomic), no
lock is ever taken on the record path; the registry lock is touched once
per thread lifetime when its ring is created. ``snapshot()`` merges the
rings from any thread; a concurrently-wrapping ring can tear a snapshot
by one span, which is the documented price of lock-freedom.

Sampling is deterministic: rate ``p`` becomes a stride ``round(1/p)`` and
every stride-th ``maybe_trace()`` call opens a trace (trace id > 0); the
runtime threads that id through the batch's lifecycle so a sampled batch
records its FULL chain (entry → host gates → split decision →
compile-cache lookup → device dispatch → settle/exit) and an unsampled
batch records nothing. With the recorder disabled the runtime's
instrumentation sites reduce to one attribute check.

Timestamps are integer nanoseconds. Under a real clock they come from
``time.perf_counter_ns``; under the test suite's manual/virtual clock
(anything exposing ``set_ms`` — core/clock.ManualClock) they derive from
``clock.now_ms() * 1e6`` so span durations follow virtual time exactly
(:func:`SpanRecorder.for_clock`).

Span schema (``snapshot()`` dicts — docs/OBSERVABILITY.md):
``trace`` (sampled trace id), ``name``, ``start_ns``, ``end_ns``,
``dur_ns``, ``thread`` (ident), ``n`` (event count the span covered),
``note`` (free-form: route taken, sub-batch sizes, ...).

Causal links: traces relate across the fan-in/fan-out points of
the serving stack — many request traces coalesce into one batch trace at
an ingest flush, and the batch fans back out to per-request verdicts at
settle. :meth:`link` records one ``(src, dst, kind, ts_ns)`` edge per
relation into per-thread rings of the same lock-free shape as the span
rings; :meth:`causal` computes the trace-id closure over those edges so
``chain(request_id)`` returns the request's FULL lifecycle: its own
frontend spans, the flush batch's pipeline/device spans, and the settle
edge back. ``verdict`` edges (batch→request fan-out) are only expanded
from the closure root — walking them from an interior batch node would
pull every sibling request of the batch into every request's chain.

Ring overflow is an explicit signal: every overwritten span/link
fires ``on_wrap`` (wired by RuntimeObs to the ``obs.span_ring_wrap``
counter) so operators can see when capacity 2048 is too small instead of
silently losing the tail.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

DEFAULT_CAPACITY = 2048
LINK_CAPACITY = 4096

#: link kinds (the causal-edge vocabulary; docs/OBSERVABILITY.md)
LINK_FLUSH = "flush"        # request trace → the batch trace that took it
LINK_VERDICT = "verdict"    # batch trace → one request trace it settled


class _Ring:
    __slots__ = ("buf", "idx")

    def __init__(self) -> None:
        self.buf: list = []
        self.idx = 0


class SpanRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 sample: float = 1.0, time_ns=None, on_wrap=None) -> None:
        self.capacity = max(16, int(capacity))
        # rate → stride: 1.0 records every trace, 0.01 every 100th, ≤0 none
        self._stride = 0 if sample <= 0 else max(1, round(1.0 / sample))
        self.sample = 0.0 if sample <= 0 else 1.0 / self._stride
        self._time_ns = time_ns or time.perf_counter_ns
        self._dispatch_seq = itertools.count()   # sampling stride counter
        self._trace_seq = itertools.count(1)     # issued trace ids
        self._tls = threading.local()
        self._rings: List[_Ring] = []
        self._link_rings: List[_Ring] = []
        self._rings_lock = threading.Lock()
        # fired once per OVERWRITTEN span/link (ring wrapped past a live
        # entry); RuntimeObs wires it to the obs.span_ring_wrap counter
        self.on_wrap = on_wrap
        self.enabled = True

    @staticmethod
    def for_clock(clock, capacity: int = DEFAULT_CAPACITY,
                  sample: float = 1.0, on_wrap=None) -> "SpanRecorder":
        """Recorder whose ns timestamps ride a manual/virtual clock when
        one is installed (tests), the monotonic clock otherwise."""
        tfn = None
        if clock is not None and hasattr(clock, "set_ms"):
            tfn = lambda: int(clock.now_ms()) * 1_000_000   # noqa: E731
        return SpanRecorder(capacity=capacity, sample=sample, time_ns=tfn,
                            on_wrap=on_wrap)

    # ---- hot path ----------------------------------------------------

    def now_ns(self) -> int:
        return self._time_ns()

    def maybe_trace(self) -> int:
        """→ a fresh trace id when this dispatch is sampled, else 0."""
        if not self.enabled or self._stride == 0:
            return 0
        if next(self._dispatch_seq) % self._stride:
            return 0
        return next(self._trace_seq)

    def mint(self) -> int:
        """A fresh trace id UNCONDITIONALLY (no sampling stride) — the
        flight recorder's always-on tier: every request/batch gets an id
        so an SLO trigger can retroactively pin any chain, not just the
        stride-sampled ones. → 0 only when the recorder is disabled."""
        if not self.enabled:
            return 0
        return next(self._trace_seq)

    def record(self, trace_id: int, name: str, start_ns: int, end_ns: int,
               n: int = 0, note: str = "") -> None:
        if not trace_id or not self.enabled:
            return
        try:
            ring = self._tls.ring
        except AttributeError:
            ring = _Ring()
            self._tls.ring = ring
            with self._rings_lock:
                self._rings.append(ring)
        entry = (trace_id, name, int(start_ns), int(end_ns),
                 threading.get_ident(), int(n), note)
        if len(ring.buf) < self.capacity:
            ring.buf.append(entry)
        else:
            ring.buf[ring.idx % self.capacity] = entry
            if self.on_wrap is not None:
                self.on_wrap()
        ring.idx += 1

    def link(self, src: int, dst: int, kind: str) -> None:
        """One causal edge ``src trace → dst trace`` (fan-in: request →
        flush batch; fan-out: batch → request verdict). Same lock-free
        per-thread ring discipline as :meth:`record`."""
        if not src or not dst or not self.enabled:
            return
        try:
            ring = self._tls.links
        except AttributeError:
            ring = _Ring()
            self._tls.links = ring
            with self._rings_lock:
                self._link_rings.append(ring)
        entry = (int(src), int(dst), kind, self._time_ns())
        if len(ring.buf) < LINK_CAPACITY:
            ring.buf.append(entry)
        else:
            ring.buf[ring.idx % LINK_CAPACITY] = entry
            if self.on_wrap is not None:
                self.on_wrap()
        ring.idx += 1

    # ---- read side ---------------------------------------------------

    def snapshot(self, limit: Optional[int] = None,
                 trace_id: Optional[int] = None) -> List[Dict]:
        with self._rings_lock:
            rings = list(self._rings)
        spans = []
        for ring in rings:
            spans.extend(list(ring.buf))   # atomic-enough copy (see module)
        if trace_id is not None:
            spans = [s for s in spans if s[0] == trace_id]
        spans.sort(key=lambda s: (s[0], s[2]))
        if limit is not None and len(spans) > limit:
            spans = spans[-limit:]
        return [{"trace": s[0], "name": s[1], "start_ns": s[2],
                 "end_ns": s[3], "dur_ns": s[3] - s[2], "thread": s[4],
                 "n": s[5], "note": s[6]} for s in spans]

    def links_snapshot(self, limit: Optional[int] = None) -> List[Dict]:
        """All recorded causal edges, ts-ordered."""
        links = self._raw_links()
        links.sort(key=lambda e: e[3])
        if limit is not None and len(links) > limit:
            links = links[-limit:]
        return [{"src": e[0], "dst": e[1], "kind": e[2], "ts_ns": e[3]}
                for e in links]

    def _raw_links(self) -> list:
        with self._rings_lock:
            rings = list(self._link_rings)
        links = []
        for ring in rings:
            links.extend(list(ring.buf))   # atomic-enough copy (see module)
        return links

    def causal(self, trace_id: int) -> Dict:
        """The causal closure of one trace: ``{"root", "spans", "links"}``.

        Follows recorded edges forward from ``trace_id`` to a fixpoint.
        ``verdict`` (fan-out) edges expand only from the root itself:
        from a request root, the flush edge reaches the batch and the
        batch's verdict edge BACK to this request is kept (both endpoints
        are in the closure) while sibling requests stay out; from a batch
        root, the fan-out to every request it settled is the point."""
        raw = self._raw_links()
        ids = {int(trace_id)}
        changed = True
        while changed:
            changed = False
            for src, dst, kind, _ts in raw:
                if (src in ids and dst not in ids
                        and (kind != LINK_VERDICT or src == trace_id)):
                    ids.add(dst)
                    changed = True
        spans = self.snapshot()
        spans = [s for s in spans if s["trace"] in ids]
        spans.sort(key=lambda s: s["start_ns"])
        links = [{"src": e[0], "dst": e[1], "kind": e[2], "ts_ns": e[3]}
                 for e in sorted(raw, key=lambda e: e[3])
                 if e[0] in ids and e[1] in ids]
        return {"root": int(trace_id), "spans": spans, "links": links}

    def chain(self, trace_id: int) -> List[Dict]:
        """All spans reachable from one trace id, start-ordered: the
        trace's own spans plus — through recorded causal links — the
        flush batch / settle spans of its full lifecycle (the demo's
        "full span chain" view; identical to a single-trace filter when
        no links were recorded)."""
        return self.causal(trace_id)["spans"]

    def last_trace_id(self) -> int:
        """Highest trace id with at least one recorded span (0 if none)."""
        with self._rings_lock:
            rings = list(self._rings)
        best = 0
        for ring in rings:
            for s in list(ring.buf):
                if s[0] > best:
                    best = s[0]
        return best

    def clear(self) -> None:
        with self._rings_lock:
            rings = list(self._rings) + list(self._link_rings)
            self._rings = []
            self._link_rings = []
        for ring in rings:
            ring.buf = []
            ring.idx = 0
        # threads still holding a cleared ring re-register on next record
        self._tls = threading.local()

    def close(self) -> None:
        """Idempotent: disable recording and drop the rings. The recorder
        owns no thread, so close is purely a state transition (safe to
        call from Sentinel.close() repeatedly)."""
        self.enabled = False
        self.clear()
