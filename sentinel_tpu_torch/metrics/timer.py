"""Per-second metric aggregation → rolling files.

Reference: ``sentinel-core/.../node/metric/MetricTimerListener.java`` — a 1 s
scheduled task (started by ``FlowRuleManager``'s static init) that snapshots
every ClusterNode (+ the global ENTRY_NODE) per whole second and hands the
nodes to ``MetricWriter``. Here the per-second read is one device gather over
the minute ring (:func:`sentinel_tpu_torch.stats.window.bucket_snapshot`) and the
loop is a daemon thread on the runtime's clock (virtual-time friendly:
``tick()`` is callable directly in tests)."""

from __future__ import annotations

import threading
from typing import Optional

from sentinel_tpu_torch.metrics.writer import MetricWriter


class MetricTimerListener:
    def __init__(self, sentinel, writer: Optional[MetricWriter] = None,
                 flush_interval_sec: int = 1):
        cfg = sentinel.cfg
        self._sentinel = sentinel
        self.writer = writer or MetricWriter(
            cfg.metric_dir(), cfg.app_name,
            single_file_size=cfg.metric_log_single_size,
            total_file_count=cfg.metric_log_total_count)
        self._interval = max(flush_interval_sec, 1)
        # seconds from construction onward get written (reference: the timer
        # is started by FlowRuleManager static init, before any traffic)
        self._last_written_sec = sentinel.clock.now_ms() // 1000 - 1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Sentinel.close() stops this daemon (idempotently — stop() is
        # re-callable): no metric-timer thread leak across open/close
        reg = getattr(sentinel, "register_shutdown", None)
        if reg is not None:
            reg(self)

    def tick(self) -> int:
        """Aggregate every completed-but-unwritten second up to now; → number
        of seconds written. Called by the daemon loop, or directly in tests
        driving a manual clock."""
        now_sec = self._sentinel.clock.now_ms() // 1000
        written = 0
        # catch up at most one minute ring — older buckets have been recycled
        start = max(self._last_written_sec + 1, now_sec - 59)
        for sec in range(start, now_sec):   # only COMPLETED seconds
            nodes = self._sentinel.metrics_snapshot(sec * 1000)
            if nodes:
                self.writer.write(sec * 1000, nodes)
                written += 1
            self._last_written_sec = sec
        # piggyback the breaker-transition poll (EventObserverRegistry
        # analog notifies within one tick; no-op without observers)
        check = getattr(self._sentinel, "check_breaker_transitions", None)
        if check is not None:
            check()
        # ... and the block-event log flush (obs/eventlog.py buffers
        # sampled denial records; this is their 1 s drain to disk)
        obs = getattr(self._sentinel, "obs", None)
        if obs is not None:
            obs.flush()
        return written

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self._interval):
                try:
                    self.tick()
                except Exception:   # pragma: no cover — keep the daemon alive
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="sentinel-metric-timer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self.writer.close()
