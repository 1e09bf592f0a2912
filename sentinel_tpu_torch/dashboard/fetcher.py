"""Metric fetcher: poll every healthy machine's ``/metric`` command and
aggregate into the in-memory repository (reference
``sentinel-dashboard/.../metric/MetricFetcher.java:72-183``).

Per app, the fetcher tracks the last fetched second and pulls the window
``[last, now - DELAY]`` (metrics for the current second are still being
written agent-side) and merges lines from all machines by ``(resource, ts)``.
The agent's ``metric`` command already hides the synthetic
``__total_inbound_traffic__`` row unless requested by name
(``SendMetricCommandHandler`` behavior), so per-resource charts never see it.

The PyTorch port's own copy of ``sentinel_tpu/dashboard/fetcher.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from sentinel_tpu_torch.dashboard.client import AgentUnreachable, SentinelApiClient
from sentinel_tpu_torch.dashboard.discovery import AppManagement
from sentinel_tpu_torch.dashboard.repository import (
    InMemoryMetricsRepository, MetricEntity,
)

FETCH_INTERVAL_S = 6          # MetricFetcher.java:66 FETCH_INTERVAL_SECOND
DELAY_MS = 2_000              # stay behind "now" so agent seconds are closed
MAX_SPAN_MS = 60_000          # cap one pull to a minute of backlog


class MetricFetcher:
    def __init__(self, apps: AppManagement, repo: InMemoryMetricsRepository,
                 client: Optional[SentinelApiClient] = None,
                 clock=None):
        self.apps = apps
        self.repo = repo
        self.client = client or SentinelApiClient()
        self._clock = clock
        self._last_fetch_ms: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _now_ms(self) -> int:
        return (self._clock.now_ms() if self._clock is not None
                else int(time.time() * 1000))

    def fetch_once(self, app: str) -> int:
        """Pull one window for ``app``; returns entities saved."""
        now = self._now_ms()
        end = (now - DELAY_MS) // 1000 * 1000
        start = self._last_fetch_ms.get(app, end - FETCH_INTERVAL_S * 1000)
        if end - start > MAX_SPAN_MS:
            start = end - MAX_SPAN_MS
        if end <= start:
            return 0
        # (resource, ts) -> MetricEntity accumulated over machines
        agg: Dict[tuple, MetricEntity] = {}
        for m in self.apps.healthy_machines(app, now):
            try:
                nodes = self.client.fetch_metrics(m.ip, m.port, start, end - 1)
            except AgentUnreachable:
                continue
            for n in nodes:
                key = (n.resource, n.timestamp)
                e = agg.get(key)
                if e is None:
                    agg[key] = MetricEntity(
                        app=app, timestamp=n.timestamp, resource=n.resource,
                        pass_qps=n.pass_qps, block_qps=n.block_qps,
                        success_qps=n.success_qps,
                        exception_qps=n.exception_qps,
                        rt=float(n.rt), count=1)
                else:
                    total = e.count + 1
                    e.rt = (e.rt * e.count + n.rt) / total
                    e.count = total
                    e.pass_qps += n.pass_qps
                    e.block_qps += n.block_qps
                    e.success_qps += n.success_qps
                    e.exception_qps += n.exception_qps
        self.repo.save_all(list(agg.values()), now)
        self._last_fetch_ms[app] = end
        return len(agg)

    def fetch_all_once(self) -> int:
        return sum(self.fetch_once(app) for app in self.apps.app_names())

    def start(self, interval_s: float = FETCH_INTERVAL_S) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.fetch_all_once()
                except Exception:       # keep the poller alive
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="dashboard-metric-fetcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
