"""Datasource SPI (reference ``sentinel-datasource-extension/.../datasource``).

* :class:`ReadableDataSource` — ``loadConfig()`` + ``getProperty()``; register
  the property into a rule manager cell and rule updates flow automatically
  (``AbstractDataSource.java:1-40``).
* :class:`AutoRefreshDataSource` — poll loop (default 3 s,
  ``AutoRefreshDataSource.java:32-45``).
* :class:`FileRefreshableDataSource` — mtime-gated file reload.
* :class:`FileWritableDataSource` — persistence for dashboard pushes.

The refresh loop takes the clock so tests can drive it virtually via
``refresh_now()``.

The PyTorch port's own copy of ``sentinel_tpu/datasource/base.py``.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Generic, Optional, TypeVar

from sentinel_tpu_torch.core.logs import record_log
from sentinel_tpu_torch.core.property import SentinelProperty

S = TypeVar("S")
T = TypeVar("T")

Converter = Callable[[S], T]

DEFAULT_REFRESH_MS = 3000


class ReadableDataSource(Generic[S, T]):
    def load_config(self) -> T:
        raise NotImplementedError

    def get_property(self) -> SentinelProperty:
        raise NotImplementedError

    def close(self) -> None:
        pass


class WritableDataSource(Generic[T]):
    def write(self, value: T) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class AbstractDataSource(ReadableDataSource[S, T]):
    """converter + property cell; subclasses implement ``read_source``."""

    def __init__(self, converter: Converter):
        if converter is None:
            raise ValueError("converter can't be null")
        self.converter = converter
        self.property: SentinelProperty = SentinelProperty()

    def read_source(self) -> S:
        raise NotImplementedError

    def load_config(self) -> T:
        return self.converter(self.read_source())

    def get_property(self) -> SentinelProperty:
        return self.property


class AutoRefreshDataSource(AbstractDataSource[S, T]):
    """Background poll loop; ``is_modified()`` short-circuits no-op reloads."""

    def __init__(self, converter: Converter,
                 refresh_ms: int = DEFAULT_REFRESH_MS, *,
                 start_thread: bool = True):
        super().__init__(converter)
        if refresh_ms <= 0:
            raise ValueError("refresh_ms must be positive")
        self.refresh_ms = refresh_ms
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._start_thread = start_thread

    def initialize(self) -> None:
        """First load + start the refresh loop (ctor tail in the reference)."""
        try:
            self.property.update_value(self.load_config())
        except Exception as exc:
            record_log().warning("datasource initial load failed: %r", exc)
        if self._start_thread:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="sentinel-ds-refresh")
            self._thread.start()

    def is_modified(self) -> bool:
        return True

    def refresh_now(self) -> bool:
        """One poll step (test hook + loop body). True if value updated."""
        try:
            if not self.is_modified():
                return False
            return self.property.update_value(self.load_config())
        except Exception as exc:
            record_log().warning("datasource refresh failed: %r", exc)
            return False

    def _loop(self) -> None:
        while not self._stop.wait(self.refresh_ms / 1000.0):
            self.refresh_now()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


class FileRefreshableDataSource(AutoRefreshDataSource[str, T]):
    """Re-reads a file when its mtime changes
    (``FileRefreshableDataSource.java``)."""

    def __init__(self, path: str, converter: Converter,
                 refresh_ms: int = DEFAULT_REFRESH_MS,
                 encoding: str = "utf-8", *, start_thread: bool = True):
        super().__init__(converter, refresh_ms, start_thread=start_thread)
        self.path = os.path.abspath(path)
        self.encoding = encoding
        self._last_mtime: float = -1.0
        self.initialize()

    def read_source(self) -> str:
        try:
            st = os.stat(self.path)
        except FileNotFoundError:
            self._last_mtime = -1.0
            return ""
        self._last_mtime = st.st_mtime
        with open(self.path, encoding=self.encoding) as fh:
            return fh.read()

    def is_modified(self) -> bool:
        try:
            return os.stat(self.path).st_mtime != self._last_mtime
        except FileNotFoundError:
            return self._last_mtime != -1.0


class FileWritableDataSource(WritableDataSource[T]):
    """Serializes values to a file (``FileWritableDataSource.java``)."""

    def __init__(self, path: str, encoder: Callable[[T], str],
                 encoding: str = "utf-8"):
        self.path = os.path.abspath(path)
        self.encoder = encoder
        self.encoding = encoding
        self._lock = threading.Lock()

    def write(self, value: T) -> None:
        text = self.encoder(value)
        with self._lock:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding=self.encoding) as fh:
                fh.write(text)
            os.replace(tmp, self.path)
