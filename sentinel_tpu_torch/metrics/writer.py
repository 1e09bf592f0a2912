"""Rolling per-second metric files with a binary seek index.

Reference: ``sentinel-core/.../node/metric/MetricWriter.java`` — files named
``{app}-metrics.log.{yyyy-MM-dd}[.N]`` in the csp log dir, each with a
``.idx`` companion of (second:int64, byte-offset:int64) big-endian pairs
written at every new second (``writeIndex:186-190``); rotation on single-file
size (default 50 MB), day roll, and total-file-count pruning of oldest
(``removeMoreFiles``). Same on-disk formats here so the reference's
``MetricSearcher``/dashboard can read our files directly.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import time as _time
from typing import List, Optional, Sequence

from sentinel_tpu_torch.metrics.node import MetricNode

METRIC_FILE = "metrics.log"
IDX_SUFFIX = ".idx"
_IDX_ENTRY = struct.Struct(">qq")   # Java DataOutputStream.writeLong × 2


def form_metric_file_name(app_name: str, pid: Optional[int] = None) -> str:
    """``MetricWriter.formMetricFileName:376-390`` (dots in app → _)."""
    name = (app_name or "").replace(".", "_")
    base = f"{name}-{METRIC_FILE}"
    if pid is not None:
        base += f".pid{pid}"
    return base


def _date_str(ms: int) -> str:
    return _time.strftime("%Y-%m-%d", _time.localtime(ms / 1000))


def _file_sort_key(name: str):
    """Order ``base.date`` < ``base.date.1`` < ``base.date.2`` …"""
    m = re.search(r"\.(\d{4}-\d{2}-\d{2})(?:\.(\d+))?$", name)
    if not m:
        return ("", 0)
    return (m.group(1), int(m.group(2) or 0))


def list_metric_files(base_dir: str, base_name: str) -> List[str]:
    """All data files (no .idx/.lck) for the app, oldest first."""
    try:
        entries = os.listdir(base_dir)
    except FileNotFoundError:
        return []
    out = [f for f in entries
           if f.startswith(base_name + ".") and not f.endswith(IDX_SUFFIX)
           and not f.endswith(".lck")]
    out.sort(key=_file_sort_key)
    return [os.path.join(base_dir, f) for f in out]


class MetricWriter:
    def __init__(self, base_dir: str, app_name: str,
                 single_file_size: int = 50 * 1024 * 1024,
                 total_file_count: int = 6,
                 use_pid: bool = False):
        self.base_dir = base_dir
        self.base_name = form_metric_file_name(
            app_name, os.getpid() if use_pid else None)
        self.single_file_size = single_file_size
        self.total_file_count = max(total_file_count, 1)
        self._lock = threading.Lock()
        self._file = None
        self._idx = None
        self._cur_path: Optional[str] = None
        self._last_second: Optional[int] = None
        self._cur_day: Optional[str] = None
        os.makedirs(base_dir, exist_ok=True)

    # -- file management ---------------------------------------------------

    def _next_file_of_day(self, ms: int) -> str:
        date = _date_str(ms)
        model = f"{self.base_name}.{date}"
        existing = [os.path.basename(p)
                    for p in list_metric_files(self.base_dir, self.base_name)
                    if os.path.basename(p).startswith(model)]
        if not existing:
            return os.path.join(self.base_dir, model)
        last = max((_file_sort_key(f)[1] for f in existing), default=0)
        return os.path.join(self.base_dir, f"{model}.{last + 1}")

    def _roll(self, ms: int) -> None:
        self._close_streams()
        self._prune()
        path = self._next_file_of_day(ms)
        self._file = open(path, "ab")
        self._idx = open(path + IDX_SUFFIX, "ab")
        self._cur_path = path
        self._cur_day = _date_str(ms)

    def _prune(self) -> None:
        files = list_metric_files(self.base_dir, self.base_name)
        while len(files) >= self.total_file_count:
            victim = files.pop(0)
            for p in (victim, victim + IDX_SUFFIX):
                try:
                    os.remove(p)
                except OSError:
                    pass

    def _close_streams(self) -> None:
        for fh in (self._file, self._idx):
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass
        self._file = self._idx = None

    # -- public API --------------------------------------------------------

    def write(self, time_ms: int, nodes: Sequence[MetricNode]) -> None:
        """Append one second's nodes; stamps them all with ``time_ms``
        (``MetricWriter.write:120-174``)."""
        if not nodes:
            return
        with self._lock:
            for n in nodes:
                n.timestamp = time_ms
            second = time_ms // 1000
            if self._file is None or not os.path.exists(self._cur_path):
                self._roll(time_ms)
            if self._last_second is not None and second < self._last_second:
                return   # out-of-order second: drop, like the reference
            if self._last_second is None or second > self._last_second:
                if self._cur_day != _date_str(time_ms):
                    self._roll(time_ms)
                self._idx.write(_IDX_ENTRY.pack(second, self._file.tell()))
                self._idx.flush()
            for n in nodes:
                self._file.write(n.to_fat_string().encode("utf-8"))
            self._file.flush()
            if self._file.tell() >= self.single_file_size:
                self._roll(time_ms)
            self._last_second = second

    def close(self) -> None:
        with self._lock:
            self._close_streams()
