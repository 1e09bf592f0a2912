"""Metric file search: seek by index, filter by time/resource.

Reference: ``sentinel-core/.../node/metric/MetricSearcher.java`` +
``MetricsReader.java`` — locate the file/offset of the first second >=
beginTime via the binary .idx, then stream fat lines until past endTime or
the line cap (the ``metric`` transport command's backing,
``SendMetricCommandHandler.java:43-86``)."""

from __future__ import annotations

import os
from typing import List, Optional

from sentinel_tpu_torch.metrics.node import MetricNode
from sentinel_tpu_torch.metrics.writer import IDX_SUFFIX, list_metric_files

from sentinel_tpu_torch.metrics.writer import _IDX_ENTRY  # single on-disk format def
MAX_LINES_RETURN = 100_000   # MetricsReader.maxLinesReturn


class MetricSearcher:
    def __init__(self, base_dir: str, base_name: str):
        self.base_dir = base_dir
        self.base_name = base_name

    def _idx_offset_for(self, path: str, begin_sec: int) -> Optional[int]:
        """Byte offset of the first indexed second >= begin_sec, or None when
        the whole file is older."""
        try:
            with open(path + IDX_SUFFIX, "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            return None
        for i in range(0, len(data) - _IDX_ENTRY.size + 1, _IDX_ENTRY.size):
            sec, offset = _IDX_ENTRY.unpack_from(data, i)
            if sec >= begin_sec:
                return offset
        return None

    def _last_sec_of(self, path: str) -> Optional[int]:
        try:
            size = os.path.getsize(path + IDX_SUFFIX)
            if size < _IDX_ENTRY.size:
                return None
            with open(path + IDX_SUFFIX, "rb") as fh:
                fh.seek((size // _IDX_ENTRY.size - 1) * _IDX_ENTRY.size)
                sec, _ = _IDX_ENTRY.unpack(fh.read(_IDX_ENTRY.size))
            return sec
        except OSError:
            return None

    def find(self, begin_time_ms: int, end_time_ms: Optional[int] = None,
             identity: Optional[str] = None,
             max_lines: int = MAX_LINES_RETURN) -> List[MetricNode]:
        """All metric nodes with begin <= ts (<= end), optionally one
        resource (``findByTimeAndResource``)."""
        begin_sec = begin_time_ms // 1000
        out: List[MetricNode] = []
        for path in list_metric_files(self.base_dir, self.base_name):
            last = self._last_sec_of(path)
            if last is not None and last < begin_sec:
                continue   # entire file predates the window
            offset = self._idx_offset_for(path, begin_sec)
            if offset is None:
                offset = 0
            try:
                with open(path, "rb") as fh:
                    fh.seek(offset)
                    for raw in fh:
                        try:
                            node = MetricNode.from_fat_string(
                                raw.decode("utf-8", "replace"))
                        except (ValueError, IndexError):
                            continue
                        if node.timestamp < begin_time_ms:
                            continue
                        if end_time_ms is not None and node.timestamp > end_time_ms:
                            return out
                        if identity is not None and node.resource != identity:
                            continue
                        out.append(node)
                        if len(out) >= max_lines:
                            return out
            except OSError:
                continue
        return out
