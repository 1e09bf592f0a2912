"""HTTP datasources (reference pull sources — Consul/Eureka/Spring-Cloud-
Config style: poll a config endpoint, short-circuit on unchanged content;
optional long-poll with an index/ETag the way Consul blocks queries).

``HttpRefreshableDataSource`` GETs ``url`` every ``refresh_ms`` and updates
the property only when the body changed (ETag/Last-Modified respected when
the server provides them). ``HttpLongPollDataSource`` adds Consul-style
blocking reads: pass ``index_header`` (e.g. ``X-Consul-Index``) and the
source re-issues the request with the last seen index as a query param so
the server can hold the request until a change.

The PyTorch port's own copy of ``sentinel_tpu/datasource/http.py``.
"""

from __future__ import annotations

import urllib.error
import urllib.request
from typing import Dict, Optional

from sentinel_tpu_torch.core.logs import record_log
from sentinel_tpu_torch.datasource.base import (
    AutoRefreshDataSource, Converter, DEFAULT_REFRESH_MS, T,
)


class HttpRefreshableDataSource(AutoRefreshDataSource[str, T]):
    def __init__(self, url: str, converter: Converter,
                 refresh_ms: int = DEFAULT_REFRESH_MS, *,
                 headers: Optional[Dict[str, str]] = None,
                 timeout_s: float = 5.0, start_thread: bool = True):
        self.url = url
        self.headers = dict(headers or {})
        self.timeout_s = timeout_s
        self._etag: Optional[str] = None
        self._last_modified: Optional[str] = None
        self._last_body: Optional[str] = None
        super().__init__(converter, refresh_ms, start_thread=start_thread)
        self.initialize()

    def _request(self) -> urllib.request.Request:
        req = urllib.request.Request(self.url, headers=self.headers)
        if self._etag:
            req.add_header("If-None-Match", self._etag)
        if self._last_modified:
            req.add_header("If-Modified-Since", self._last_modified)
        return req

    def read_source(self) -> str:
        try:
            with urllib.request.urlopen(self._request(),
                                        timeout=self.timeout_s) as r:
                body = r.read().decode("utf-8")
                # commit validators only after the body arrived intact — a
                # failed read must not pin future polls to 304/stale-body
                self._etag = r.headers.get("ETag") or self._etag
                self._last_modified = (r.headers.get("Last-Modified")
                                       or self._last_modified)
                self._last_body = body
                return body
        except urllib.error.HTTPError as exc:
            if exc.code == 304 and self._last_body is not None:
                return self._last_body       # not modified
            raise

    def is_modified(self) -> bool:
        # conditional requests make the full read cheap; decide there
        return True

    def refresh_now(self) -> bool:
        try:
            before = self._last_body
            body = self.read_source()
            # a blocking read (long-poll) can outlive close(): a response
            # arriving after stop must not fire listeners
            if self._stop.is_set():
                return False
            if body == before:
                return False
            return self.property.update_value(self.converter(body))
        except Exception as exc:
            record_log().warning("http datasource refresh failed: %r", exc)
            return False


class HttpLongPollDataSource(HttpRefreshableDataSource[T]):
    """Blocking-query pull (Consul watch style): the server holds the
    request until the watched key changes past ``index``."""

    def __init__(self, url: str, converter: Converter, *,
                 index_header: str = "X-Consul-Index",
                 index_param: str = "index",
                 wait: str = "25s",
                 refresh_ms: int = 1_000,     # near-immediate re-poll
                 **kw):
        self.index_header = index_header
        self.index_param = index_param
        self.wait = wait
        self._index: Optional[str] = None
        super().__init__(url, converter, refresh_ms, **kw)

    def _request(self) -> urllib.request.Request:
        url = self.url
        if self._index:
            sep = "&" if "?" in url else "?"
            url = f"{url}{sep}{self.index_param}={self._index}&wait={self.wait}"
        return urllib.request.Request(url, headers=self.headers)

    def read_source(self) -> str:
        with urllib.request.urlopen(self._request(),
                                    timeout=self.timeout_s + 30) as r:
            body = r.read().decode("utf-8")
            # commit the blocking-query index only after the body arrived —
            # otherwise a dropped connection skips this change forever
            self._index = r.headers.get(self.index_header) or self._index
            self._last_body = body
            return body

class InProcessDataSource(AutoRefreshDataSource[object, T]):
    """Push source for embedding apps (reference push datasources collapse
    to this when the transport is in-process): call :meth:`push` with the
    raw source value and every registered listener converges — same
    property-cell choke point as Nacos/ZK/etcd listeners (SURVEY §3.5b)."""

    def __init__(self, converter: Converter, initial=None):
        self._value = initial
        super().__init__(converter, refresh_ms=3_600_000, start_thread=False)
        if initial is not None:      # no spurious converter(None) at init
            self.initialize()

    def read_source(self):
        return self._value

    def push(self, value) -> bool:
        self._value = value
        return self.property.update_value(self.converter(value))
