"""Sampled structured block-event log (reference: Sentinel's block log /
the EagleEye record), riding the metric-file rotation machinery.

Where ``core/logs.BlockStatLogger`` rolls denials up per second for the
pipe-delimited block log, this log keeps individual (sampled) denial
RECORDS in the dashboard-readable metric-line format: each event becomes
one :class:`~sentinel_tpu_torch.metrics.node.MetricNode` fat line written
through a dedicated :class:`~sentinel_tpu_torch.metrics.writer.MetricWriter`
(same size/day rotation + .idx sidecar), under the app name
``<app>-block`` — so ``MetricSearcher(dir, form_metric_file_name(app +
"-block"))`` reads events back by time range and resource
(tests/test_obs.py pins the round trip).

Record encoding (docs/OBSERVABILITY.md):

* ``resource`` — the denied resource; when the event carried an origin it
  is appended as ``resource@origin`` (``@`` survives the writer's ``|``
  sanitization, and origin-less events stay exactly searchable by name);
* ``block_qps`` — how many denials this (sampled) record represents (the
  batch tier groups identical denials before logging);
* ``classification`` — the int8 verdict reason code
  (``BlockReason`` / custom-slot codes, ``slot_name_for_code``);
* everything else 0.

Sampling shares the span recorder's deterministic stride
(``SENTINEL_TRACE_SAMPLE``); until :meth:`configure` attaches a writer,
events buffer in a bounded deque readable via :meth:`snapshot` (the
transport/dashboard "recent denials" view) without touching disk.
"""

from __future__ import annotations

import collections
import itertools
import threading
from typing import Dict, List, Optional

RECENT_CAP = 256          # in-memory tail for the command surface
PENDING_CAP = 4096        # un-flushed disk buffer bound (oldest dropped)


class BlockEventLog:
    def __init__(self, sample: float = 1.0) -> None:
        self._stride = 0 if sample <= 0 else max(1, round(1.0 / sample))
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._pending: List[tuple] = []      # (ms, resource, code, origin, n)
        self._recent: "collections.deque" = collections.deque(
            maxlen=RECENT_CAP)
        self._dropped = 0
        self.writer = None
        self.base_name: Optional[str] = None
        self._closed = False

    def configure(self, base_dir: str, app_name: str, *,
                  single_file_size: int = 50 * 1024 * 1024,
                  total_file_count: int = 6) -> str:
        """Attach the rolling metric writer (idempotent per instance);
        → the on-disk base file name the searcher should use."""
        from sentinel_tpu_torch.metrics.writer import MetricWriter, \
            form_metric_file_name
        if self.writer is None:
            self.writer = MetricWriter(
                base_dir, app_name + "-block",
                single_file_size=single_file_size,
                total_file_count=total_file_count)
            self.base_name = form_metric_file_name(app_name + "-block")
        return self.base_name

    def log(self, ms: int, resource: str, reason_code: int,
            reason_name: str = "", origin: str = "", count: int = 1) -> None:
        if self._closed or self._stride == 0:
            return
        if next(self._seq) % self._stride:
            return
        ev = (int(ms), resource, int(reason_code), origin, int(count))
        with self._lock:
            self._recent.append({"ms": ev[0], "resource": resource,
                                 "reason": int(reason_code),
                                 "reason_name": reason_name,
                                 "origin": origin, "count": int(count)})
            self._pending.append(ev)
            if len(self._pending) > PENDING_CAP:
                self._dropped += len(self._pending) - PENDING_CAP
                del self._pending[:len(self._pending) - PENDING_CAP]

    def flush(self) -> int:
        """Write pending events; → lines written. Events are grouped by
        second and written in ascending order (the writer silently drops
        seconds older than its high-water mark)."""
        if self.writer is None:
            return 0
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return 0
        from sentinel_tpu_torch.metrics.node import MetricNode
        by_sec: Dict[int, List[MetricNode]] = {}
        for ms, resource, code, origin, count in pending:
            name = f"{resource}@{origin}" if origin else resource
            by_sec.setdefault(ms // 1000, []).append(MetricNode(
                timestamp=ms, resource=name, block_qps=count,
                classification=code))
        written = 0
        for sec in sorted(by_sec):
            nodes = by_sec[sec]
            self.writer.write(sec * 1000, nodes)
            written += len(nodes)
        return written

    def snapshot(self, limit: int = 64) -> List[Dict]:
        with self._lock:
            tail = list(self._recent)
        return tail[-limit:]

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def close(self) -> None:
        """Idempotent: flush what a writer can take, then stop accepting."""
        if self._closed:
            return
        self._closed = True
        try:
            self.flush()
        finally:
            if self.writer is not None:
                self.writer.close()
