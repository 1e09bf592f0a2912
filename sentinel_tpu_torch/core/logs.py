"""Framework logging: record log + aggregated block log.

Reference: ``sentinel-core/.../log/RecordLog.java`` (``sentinel-record.log``
in ``${user.home}/logs/csp/``, overridable dir, daily-rolling) and the
EagleEye-backed block log (``slots/logger/EagleEyeLogUtil.java`` +
``eagleeye/StatLogger``): block events are NOT written per-occurrence but
rolled up per (resource, exception, limitApp, origin, ruleId) key every
second and flushed as one pipe-delimited line — that per-interval rollup is
what keeps logging off the hot path, and is reproduced here by
:class:`BlockStatLogger` (the generic rollup + async appender machinery
lives in :mod:`sentinel_tpu_torch.core.statlog`). Python's stdlib logging plays
the ``Logger`` SPI role (handlers are swappable, the slf4j-binding
analog)."""

from __future__ import annotations

import logging
import logging.handlers
import os
import threading
from typing import Dict, Optional

from sentinel_tpu_torch.core.statlog import AsyncRollingAppender, StatLogger

_DEF_DIR = os.path.join(os.path.expanduser("~"), "logs", "csp")


def log_base_dir() -> str:
    return os.environ.get("SENTINEL_TPU_LOG_DIR", _DEF_DIR)


_record_logger: Optional[logging.Logger] = None
_record_lock = threading.Lock()


def record_log(to_file: bool = True) -> logging.Logger:
    """The framework's own diagnostics channel (``RecordLog``)."""
    global _record_logger
    with _record_lock:
        if _record_logger is None:
            lg = logging.getLogger("sentinel_tpu_torch.record")
            lg.setLevel(logging.INFO)
            lg.propagate = False
            if to_file:
                try:
                    os.makedirs(log_base_dir(), exist_ok=True)
                    h = logging.handlers.TimedRotatingFileHandler(
                        os.path.join(log_base_dir(), "sentinel-record.log"),
                        when="midnight", backupCount=7, delay=True)
                    h.setFormatter(logging.Formatter(
                        "%(asctime)s %(levelname)s %(message)s"))
                    lg.addHandler(h)
                except OSError:   # unwritable home: stderr fallback
                    lg.addHandler(logging.StreamHandler())
            else:
                lg.addHandler(logging.NullHandler())
            _record_logger = lg
        return _record_logger


class BlockStatLogger(StatLogger):
    """Per-second rollup of block events → ``sentinel-block.log``.

    The generic :class:`~sentinel_tpu_torch.core.statlog.StatLogger` rollup
    (1 s period, max_entries key cap, async rolling appender) with the
    block log's fixed 5-part key and an additional per-LINE token bucket
    (``max_lines_per_sec``, burst = one second's worth) — the EagleEye
    ``TokenBucket`` analog. The DEFAULT equals ``max_entries`` so the
    documented per-interval key contract is never silently trimmed; the
    knob exists for operators with a tighter disk budget (a sustained
    block storm over high-cardinality resources still rolls up to 6000
    lines/s otherwise). Trimmed or overflowed intervals append one
    ``__dropped__`` summary line so the loss is visible, not silent.

    Line format mirrors the EagleEye stat line:
    ``ms|resource,exception,limitApp,origin,ruleId|count``."""

    FILE_NAME = "sentinel-block.log"

    def __init__(self, clock, base_dir: Optional[str] = None,
                 max_entries: int = 6000, max_bytes: int = 300 * 1024 * 1024,
                 backups: int = 3, file_name: Optional[str] = None,
                 max_lines_per_sec: Optional[int] = None):
        self._dir = base_dir or log_base_dir()
        self.file_name = file_name or self.FILE_NAME
        # size rotation + actual file IO live on the appender's flush
        # daemon — the entry/exit hot path only formats and enqueues
        # (EagleEyeRollingFileAppender + EagleEyeLogDaemon split)
        super().__init__(
            self.file_name, clock, period_ms=1000, max_entries=max_entries,
            appender=AsyncRollingAppender(
                os.path.join(self._dir, self.file_name),
                max_bytes=max_bytes, backups=backups))
        self._line_rate = max(1, max_lines_per_sec
                              if max_lines_per_sec is not None
                              else max_entries)
        self._line_tokens = float(self._line_rate)
        self._last_refill_sec = 0

    def log(self, resource: str, exception_name: str, limit_app: str = "",
            origin: str = "", rule_id: str = "", count: int = 1) -> None:
        self.stat(resource, exception_name, limit_app, origin, rule_id,
                  values=(count,))

    def close(self) -> None:
        """Flush pending rollups and retire the appender (terminal)."""
        self.flush()
        self.appender.close()

    def _take_line_tokens(self, sec: int, want: int) -> int:
        """Token-bucket refill + take → number of lines allowed now."""
        with self._lock:
            elapsed = max(0, sec - self._last_refill_sec)
            self._last_refill_sec = sec
            self._line_tokens = min(float(self._line_rate),
                                    self._line_tokens
                                    + elapsed * self._line_rate)
            granted = min(want, int(self._line_tokens))
            self._line_tokens -= granted
            return granted

    def _emit(self, bucket: int, counts: Dict, overflow: int) -> None:
        budget = self._take_line_tokens(bucket, len(counts))
        trimmed = len(counts) - budget
        ms = bucket * self._period
        lines = [f"{ms}|{','.join(k)}|{vs[0]}"
                 for k, vs in list(counts.items())[:budget]]
        if trimmed + overflow > 0:
            lines.append(f"{ms}|__dropped__|{trimmed + overflow}")
        self.appender.append_many(lines)
