"""Async rolling-file stat logging — the generic engine under the block
log and the cluster server's stat lines.

Reference: the embedded EagleEye logger (``CORE/eagleeye``, SURVEY §5):
``EagleEyeRollingFileAppender.java`` (size-rolling file appender),
``EagleEyeLogDaemon.java`` (async flush daemon — hot threads never touch
the filesystem), ``StatLogger/StatRollingData/StatEntry`` (periodic
key→counter rollups onto the appender). This module provides the same
split re-designed for the engine: a bounded in-memory line queue drained
by one daemon thread per appender (rotation included), plus a generic
periodic rollup logger; :class:`sentinel_tpu_torch.core.logs.BlockStatLogger`
and the token server's stat log ride it.

Loss is bounded and VISIBLE, never blocking: a full queue drops new lines
and the next drain appends one ``__appender_dropped__`` marker with the
count (EagleEye increments a discard counter on its ringbuffer).
"""

from __future__ import annotations

import atexit
import os
import threading
import weakref
from collections import deque
from typing import Dict, Optional, Tuple

__all__ = ["AsyncRollingAppender", "StatLogger"]

_DEFAULT_MAX_BYTES = 300 * 1024 * 1024
# weak registry: abandoned appenders stay collectable; atexit flushes
# whatever is still alive
_all_appenders: "weakref.WeakSet[AsyncRollingAppender]" = weakref.WeakSet()
_all_lock = threading.Lock()
# a drained daemon parks this many intervals with an empty queue, then
# exits (the next append revives it) — long-lived idle loggers don't pin
# a thread each for the life of the process
_IDLE_WAKEUPS_BEFORE_EXIT = 60


def _flush_all_at_exit() -> None:   # pragma: no cover — interpreter exit
    with _all_lock:
        apps = list(_all_appenders)
    for a in apps:
        try:
            a.flush()
        except Exception:
            pass


atexit.register(_flush_all_at_exit)


class AsyncRollingAppender:
    """Size-rolling file appender with an async flush daemon.

    ``append`` is wait-free for the caller: it enqueues into a bounded
    buffer (full buffer ⇒ the line is dropped and counted, never blocks)
    and the daemon thread drains every ``flush_interval_s`` — or sooner
    when the buffer passes half full. Rotation keeps ``backups`` numbered
    files (``name.1`` newest) and happens on the drain thread only, so
    the hot path never stats or opens files. ``flush()`` drains
    synchronously (shutdown hooks, tests)."""

    def __init__(self, path: str, *, max_bytes: int = _DEFAULT_MAX_BYTES,
                 backups: int = 3, flush_interval_s: float = 1.0,
                 queue_cap: int = 65536):
        self.path = path
        self._max_bytes = max_bytes
        self._backups = backups
        self._interval = flush_interval_s
        self._cap = queue_cap
        self._q: deque = deque()
        self._q_lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._dropped = 0
        self._thread: Optional[threading.Thread] = None
        with _all_lock:
            _all_appenders.add(self)

    # ------------------------------------------------------------ hot path
    def append(self, line: str) -> bool:
        """Enqueue one line (no trailing newline). False = dropped."""
        with self._q_lock:
            if len(self._q) >= self._cap:
                self._dropped += 1
                return False
            self._q.append(line)
            depth = len(self._q)
        self._ensure_daemon()
        if depth >= self._cap // 2:
            self._wake.set()
        return True

    def append_many(self, lines) -> int:
        """Enqueue many lines → number accepted."""
        n = 0
        with self._q_lock:
            room = self._cap - len(self._q)
            for line in lines:
                if n >= room:
                    self._dropped += 1
                    continue
                self._q.append(line)
                n += 1
            depth = len(self._q)
        self._ensure_daemon()
        if depth >= self._cap // 2:
            self._wake.set()
        return n

    # ------------------------------------------------------------ drain
    def flush(self) -> None:
        """Drain the queue to disk NOW, on the calling thread."""
        self._drain()

    def close(self) -> None:
        """Terminal: drain, stop the daemon, unregister. Lines appended
        after close() only reach disk via an explicit flush()."""
        self._stop.set()
        self._wake.set()
        t = self._thread  # graftlint: disable=LOCK002 -- benign: _stop is set before the read; joining a stale thread handle is harmless
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._drain()
        with _all_lock:
            _all_appenders.discard(self)

    def _ensure_daemon(self) -> None:
        if self._thread is not None and self._thread.is_alive():  # graftlint: disable=LOCK002 -- double-checked locking: this lock-free check is re-verified under _q_lock before spawning
            return
        with self._q_lock:
            if self._thread is not None and self._thread.is_alive():
                return
            if self._stop.is_set():
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"statlog-flush:{os.path.basename(self.path)}")
            self._thread.start()

    def _run(self) -> None:
        idle = 0
        while not self._stop.is_set():
            self._wake.wait(self._interval)
            self._wake.clear()
            with self._q_lock:
                empty = not self._q and not self._dropped
            if empty:
                idle += 1
                if idle >= _IDLE_WAKEUPS_BEFORE_EXIT:
                    # exit is announced under the queue lock so a racing
                    # append either lands where this check sees it, or
                    # finds _thread cleared and revives the daemon
                    with self._q_lock:
                        if not self._q and not self._dropped:
                            self._thread = None
                            return
                    idle = 0
                continue
            idle = 0
            try:
                self._drain()
            except Exception:   # pragma: no cover — daemon must survive
                pass

    def _drain(self) -> None:
        with self._q_lock:
            if not self._q and not self._dropped:
                return
            lines, self._q = self._q, deque()
            dropped, self._dropped = self._dropped, 0
        with self._io_lock:
            try:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                if (os.path.exists(self.path)
                        and os.path.getsize(self.path) > self._max_bytes):
                    for i in range(self._backups - 1, 0, -1):
                        src = f"{self.path}.{i}"
                        if os.path.exists(src):
                            os.replace(src, f"{self.path}.{i + 1}")
                    os.replace(self.path, f"{self.path}.1")
                with open(self.path, "a", encoding="utf-8") as fh:
                    for line in lines:
                        fh.write(line + "\n")
                    if dropped:
                        fh.write(f"__appender_dropped__|{dropped}\n")
            except OSError:   # pragma: no cover — never break callers on IO
                pass


class StatLogger:
    """Generic periodic key→counter rollup onto an async appender
    (reference ``StatLogger``/``StatRollingData``: entries accumulate in
    memory per period and flush as one line per key).

    Line format: ``ms|k1,k2,...|v1,v2,...`` — the same shape the block
    log and the token server's per-second stat lines use. ``max_entries``
    bounds distinct keys per period (overflow keys are dropped and
    surfaced as one ``__dropped__`` line, maxEntryCount=6000 in the
    reference)."""

    def __init__(self, name: str, clock, base_dir: Optional[str] = None,
                 *, period_ms: int = 1000, max_entries: int = 6000,
                 max_bytes: int = _DEFAULT_MAX_BYTES, backups: int = 3,
                 appender: Optional[AsyncRollingAppender] = None):
        from sentinel_tpu_torch.core.logs import log_base_dir
        self.name = name
        self._clock = clock
        self._period = max(1, period_ms)
        self._max_entries = max_entries
        self.appender = appender or AsyncRollingAppender(
            os.path.join(base_dir or log_base_dir(), f"{name}.log"),
            max_bytes=max_bytes, backups=backups)
        self._lock = threading.Lock()
        self._bucket = 0
        self._counts: Dict[Tuple[str, ...], list] = {}
        self._overflow = 0

    def stat(self, *key: str, values=(1,)) -> None:
        """Accumulate ``values`` (ints) under ``key`` for this period."""
        bucket = self._clock.now_ms() // self._period
        pending = None
        with self._lock:
            if bucket != self._bucket and self._counts:
                pending = (self._bucket, self._counts, self._overflow)
                self._counts = {}
                self._overflow = 0
            self._bucket = bucket
            cur = self._counts.get(key)
            if cur is None:
                if len(self._counts) >= self._max_entries:
                    self._overflow += 1
                    cur = None
                else:
                    cur = self._counts[key] = [0] * len(values)
            if cur is not None:
                for i, v in enumerate(values):
                    cur[i] += v
        if pending:
            self._emit(*pending)

    def flush(self) -> None:
        with self._lock:
            pending = (self._bucket, self._counts, self._overflow)
            self._counts = {}
            self._overflow = 0
        if pending[1] or pending[2]:
            self._emit(*pending)
        self.appender.flush()

    def _emit(self, bucket: int, counts: Dict, overflow: int) -> None:
        ms = bucket * self._period
        lines = [f"{ms}|{','.join(k)}|{','.join(str(v) for v in vs)}"
                 for k, vs in counts.items()]
        if overflow:
            lines.append(f"{ms}|__dropped__|{overflow}")
        self.appender.append_many(lines)
