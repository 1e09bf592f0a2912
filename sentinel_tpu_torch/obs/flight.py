"""SLO-triggered flight recorder: tail-based trace capture (Canopy,
Kaldor et al. SOSP 2017 — record everything cheaply, persist only what a
trigger retroactively pins).

The span recorder's stride sampling is head-based: whether a dispatch is
traced is decided BEFORE anyone knows it will be slow, so the tail events
the serving SLO bands police are exactly the ones a low sample rate
misses. The flight recorder inverts that: while it is active the serving
front end mints a trace id for EVERY request and batch
(``SpanRecorder.mint`` — the always-on reduced-detail tier riding the
same lock-free per-thread rings), and nothing is persisted until an SLO
trigger fires:

* ``deadline_miss`` — a request settled past its absolute deadline
  (frontend/batcher.py settle loop);
* ``shed`` — an ``IngestOverload``
  backpressure rejection;
* ``p99`` — the rolling ``hist_request`` p99 breached the
  ``SENTINEL_FLIGHT_P99_MS`` budget (checked every
  :data:`P99_CHECK_EVERY` requests);
* ``block_burst`` — more than ``SENTINEL_FLIGHT_BLOCK_BURST`` denials
  landed within one second (runtime ``_obs_block``).

A trigger pins the offending chain(s): the causal closure
(``SpanRecorder.causal`` — spans + fan-in/fan-out links) of the
triggering trace, or of the most recent traces inside the retro window
(``SENTINEL_FLIGHT_WINDOW_MS``) when the trigger has no specific root.
Pinned records buffer in memory (:meth:`snapshot` — the transport /
dashboard view) and persist through the same
:class:`~sentinel_tpu_torch.metrics.writer.MetricWriter` rotation machinery as
the block-event log, under the app name ``<app>-trace``: one fat line
per pinned chain whose ``resource`` field is the compact-JSON chain
(``json.loads``-able straight off :class:`MetricSearcher` read-back —
:func:`load_pinned`), ``block_qps`` the span count, ``classification``
the trigger code (:data:`TRIGGER_CODES`), ``rt`` the overrun/worst ms.

Triggers are rate-limited per kind to one pin per window so a trigger
storm (every request of a flash crowd missing its deadline) costs one
snapshot, not thousands. Env knobs (construction time; kwargs override):
``SENTINEL_FLIGHT_DISABLE`` — off entirely;
``SENTINEL_FLIGHT_WINDOW_MS`` — retro window AND per-kind re-trigger
gap, default 2000; ``SENTINEL_FLIGHT_P99_MS`` — p99 budget, default 0 =
trigger disabled; ``SENTINEL_FLIGHT_BLOCK_BURST`` — denials/second
threshold, default 512.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Dict, List, Optional

from sentinel_tpu_torch.obs import counters as obs_keys

FLIGHT_DISABLE_ENV = "SENTINEL_FLIGHT_DISABLE"
FLIGHT_WINDOW_ENV = "SENTINEL_FLIGHT_WINDOW_MS"
FLIGHT_P99_ENV = "SENTINEL_FLIGHT_P99_MS"
FLIGHT_BURST_ENV = "SENTINEL_FLIGHT_BLOCK_BURST"

#: trigger kind → MetricNode.classification code in the <app>-trace log
TRIGGER_CODES = {"deadline_miss": 1, "shed": 2, "p99": 3, "block_burst": 4,
                 "controller_action": 5}

RECENT_CAP = 64          # in-memory pinned-record tail (command surface)
PENDING_CAP = 256        # un-flushed disk buffer bound (oldest dropped)
MAX_CHAIN_SPANS = 192    # per pinned chain, keeps one fat line bounded
MAX_WINDOW_ROOTS = 4     # rootless triggers pin at most this many chains
P99_CHECK_EVERY = 256    # requests between rolling-p99 evaluations


def flight_disabled() -> bool:
    return os.environ.get(FLIGHT_DISABLE_ENV, "").lower() in (
        "1", "true", "on", "yes")


def _env_ms(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return max(0.0, float(raw))
    except ValueError:
        return default


class FlightRecorder:
    """One per :class:`~sentinel_tpu_torch.obs.RuntimeObs`; host-side only, no
    threads — :meth:`flush` rides the metric timer tick / close exactly
    like the block-event log."""

    def __init__(self, obs, *, enabled: Optional[bool] = None,
                 window_ms: Optional[float] = None,
                 p99_budget_ms: Optional[float] = None,
                 block_burst: Optional[int] = None) -> None:
        self._obs = obs
        self.active = (not flight_disabled()) if enabled is None else enabled
        self.window_ms = (_env_ms(FLIGHT_WINDOW_ENV, 2000.0)
                          if window_ms is None else max(1.0, float(window_ms)))
        self.p99_budget_ms = (_env_ms(FLIGHT_P99_ENV, 0.0)
                              if p99_budget_ms is None
                              else max(0.0, float(p99_budget_ms)))
        self.block_burst = (int(_env_ms(FLIGHT_BURST_ENV, 512))
                            if block_burst is None else int(block_burst))
        self._lock = threading.Lock()
        self._last_pin_ns: Dict[str, int] = {}   # per-kind rate limiter
        self._recent: "collections.deque" = collections.deque(
            maxlen=RECENT_CAP)
        self._pending: List[dict] = []
        self._req_count = 0
        self._block_sec = -1
        self._block_n = 0
        self.writer = None
        self.base_name: Optional[str] = None
        # hot-set pinning (obs/telemetry.py sets this to its flight_hot):
        # a trigger snapshots the top hot resources AT TRIGGER TIME into
        # the record, so a pinned SLO-miss chain names what was hot when
        # it happened. Must be cheap and lock-light (host list copy).
        self.hot_provider = None
        self._closed = False

    # ---- persistence wiring (bootstrap / tests) ----------------------

    def configure(self, base_dir: str, app_name: str, *,
                  single_file_size: int = 50 * 1024 * 1024,
                  total_file_count: int = 6) -> str:
        """Attach the rolling ``<app>-trace`` writer (idempotent per
        instance); → the on-disk base file name the searcher should use."""
        from sentinel_tpu_torch.metrics.writer import MetricWriter, \
            form_metric_file_name
        if self.writer is None:
            self.writer = MetricWriter(
                base_dir, app_name + "-trace",
                single_file_size=single_file_size,
                total_file_count=total_file_count)
            self.base_name = form_metric_file_name(app_name + "-trace")
        return self.base_name

    # ---- trigger surface (hot-adjacent; every call is guarded) -------

    def trigger(self, kind: str, root: int = 0, note: str = "",
                worst_ms: float = 0.0, force: bool = False) -> bool:
        """Fire one SLO trigger; → True when a chain was actually pinned
        (False: inactive, rate-limited, or nothing recorded to pin).
        ``force`` skips the per-kind rate limiter: controller actions are
        already cooldown-limited upstream and every one must leave a pin."""
        if not self.active or self._closed:
            return False
        spans = self._obs.spans
        now_ns = spans.now_ns()
        gap_ns = int(self.window_ms * 1e6)
        with self._lock:
            if not force:
                last = self._last_pin_ns.get(kind)
                if last is not None and now_ns - last < gap_ns:
                    return False
            self._last_pin_ns[kind] = now_ns
        roots = [int(root)] if root else self._window_roots(now_ns)
        if not roots:
            return False
        counters = self._obs.counters
        counters.add(obs_keys.FLIGHT_TRIGGER_PREFIX + kind)
        now_ms = int(self._obs_now_ms())
        hot: List[Dict] = []
        if self.hot_provider is not None:
            try:
                hot = list(self.hot_provider())
            except Exception:   # telemetry must not break a pin
                hot = []
        pinned = 0
        for r in roots:
            causal = spans.causal(r)
            if not causal["spans"]:
                continue
            rec = {
                "ts_ms": now_ms, "kind": kind, "root": r, "note": note,
                "worst_ms": round(float(worst_ms), 3),
                "spans": causal["spans"][:MAX_CHAIN_SPANS],
                "links": causal["links"],
                "truncated": len(causal["spans"]) > MAX_CHAIN_SPANS,
                "hot": hot,
            }
            with self._lock:
                self._recent.append(rec)
                self._pending.append(rec)
                if len(self._pending) > PENDING_CAP:
                    del self._pending[:len(self._pending) - PENDING_CAP]
            pinned += 1
        if pinned:
            counters.add(obs_keys.FLIGHT_PINNED, pinned)
        return pinned > 0

    def note_requests(self, n: int) -> None:
        """Per settled batch: roll the request count and evaluate the
        hist-detected p99 trigger every :data:`P99_CHECK_EVERY`."""
        if not self.active or self.p99_budget_ms <= 0:
            return
        self._req_count += n
        if self._req_count < P99_CHECK_EVERY:
            return
        self._req_count = 0
        p99 = self._obs.hist_request.percentile_ms(0.99)
        if p99 is not None and p99 > self.p99_budget_ms:
            self.trigger("p99", note=f"p99_ms={p99:.1f}", worst_ms=p99)

    def note_blocks(self, count: int, now_ms: int) -> None:
        """Per grouped denial record: the block-reason burst trigger
        (more than ``block_burst`` denials inside one second)."""
        if not self.active or self.block_burst <= 0:
            return
        sec = int(now_ms) // 1000
        if sec != self._block_sec:
            self._block_sec = sec
            self._block_n = 0
        self._block_n += int(count)
        if self._block_n >= self.block_burst:
            self._block_n = -(1 << 30)   # once per second; rate limiter too
            self.trigger("block_burst",
                         note=f"blocks_1s>={self.block_burst}")

    def _window_roots(self, now_ns: int) -> List[int]:
        """Most recent trace ids with a span starting inside the retro
        window (rootless triggers: p99 breach, block burst)."""
        cutoff = now_ns - int(self.window_ms * 1e6)
        ids = {s["trace"] for s in self._obs.spans.snapshot()
               if s["start_ns"] >= cutoff}
        return sorted(ids, reverse=True)[:MAX_WINDOW_ROOTS]

    def _obs_now_ms(self) -> float:
        clock = getattr(self._obs, "clock", None)
        if clock is not None:
            return clock.now_ms()
        import time
        return time.time() * 1000.0

    # ---- read / persist side -----------------------------------------

    def snapshot(self, limit: int = 16, full: bool = False) -> List[Dict]:
        """Most recent pinned records; metadata-only unless ``full``."""
        with self._lock:
            tail = list(self._recent)[-limit:]
        if full:
            return tail
        return [{k: r[k] for k in
                 ("ts_ms", "kind", "root", "note", "worst_ms", "truncated")}
                | {"spans": len(r["spans"]), "links": len(r["links"])}
                for r in tail]

    def pinned(self, root: int) -> Optional[Dict]:
        """The most recent pinned record for one root trace id."""
        with self._lock:
            for rec in reversed(self._recent):
                if rec["root"] == root:
                    return rec
        return None

    def flush(self) -> int:
        """Write pending pinned chains; → lines written. One fat line per
        chain: ``resource`` = the compact-JSON record (no ``|`` ever —
        the writer would mangle one into ``_``), grouped ascending by
        second for the writer's high-water mark."""
        if self.writer is None:
            return 0
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return 0
        from sentinel_tpu_torch.metrics.node import MetricNode
        by_sec: Dict[int, List[MetricNode]] = {}
        for rec in pending:
            blob = json.dumps(rec, separators=(",", ":"))
            by_sec.setdefault(rec["ts_ms"] // 1000, []).append(MetricNode(
                timestamp=rec["ts_ms"], resource=blob,
                block_qps=len(rec["spans"]),
                rt=int(rec.get("worst_ms") or 0),
                classification=TRIGGER_CODES.get(rec["kind"], 0)))
        written = 0
        for sec in sorted(by_sec):
            nodes = by_sec[sec]
            self.writer.write(sec * 1000, nodes)
            written += len(nodes)
        return written

    def close(self) -> None:
        """Idempotent: flush what a writer can take, then stop pinning."""
        if self._closed:
            return
        self._closed = True
        self.active = False
        try:
            self.flush()
        finally:
            if self.writer is not None:
                self.writer.close()


def load_pinned(base_dir: str, app_name: str, begin_ms: int = 0,
                end_ms: Optional[int] = None) -> List[Dict]:
    """Read pinned chains back off the ``<app>-trace`` rotation (the
    ci_gate mechanism probe / post-mortem path): every line whose
    ``resource`` parses as a chain record."""
    from sentinel_tpu_torch.metrics.searcher import MetricSearcher
    from sentinel_tpu_torch.metrics.writer import form_metric_file_name
    searcher = MetricSearcher(base_dir,
                              form_metric_file_name(app_name + "-trace"))
    out: List[Dict] = []
    for node in searcher.find(begin_ms, end_ms):
        try:
            rec = json.loads(node.resource)
        except ValueError:
            continue
        if isinstance(rec, dict) and "spans" in rec:
            out.append(rec)
    return out
