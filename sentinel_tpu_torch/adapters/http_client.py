"""Outbound HTTP client guards (reference ``sentinel-okhttp-adapter``
``SentinelOkHttpInterceptor``, ``sentinel-apache-httpclient-adapter``
``SentinelApacheHttpClientExecChainHandler``, and — for the async
variant — ``sentinel-spring-webflux-adapter``'s WebClient integration).

Resource defaults to ``httpclient:METHOD:host/path-sans-query`` like the
reference's ``OkHttpResourceExtractor``; override via ``resource_extractor``.

The PyTorch port's own copy of ``sentinel_tpu/adapters/http_client.py``.
"""

from __future__ import annotations

import urllib.parse
import urllib.request
from typing import Callable, Optional

from sentinel_tpu_torch.core.errors import BlockException
from sentinel_tpu_torch.metrics.node import TYPE_COMMON


def default_resource(method: str, url: str) -> str:
    p = urllib.parse.urlsplit(url)
    return f"httpclient:{method.upper()}:{p.netloc}{p.path}"


class SentinelSession:
    """A ``requests.Session`` subclass guarding every request.

    Defined lazily so importing this module never requires requests."""

    def __new__(cls, sentinel, *,
                resource_extractor: Optional[Callable[[str, str], str]] = None,
                **kw):
        import requests

        class _Session(requests.Session):
            def request(self, method, url, *a, **k):
                resource = (resource_extractor or default_resource)(
                    method, url)
                e = sentinel.entry(resource, entry_type=0,
                                   resource_type=TYPE_COMMON)
                try:
                    resp = super().request(method, url, *a, **k)
                except BaseException as exc:
                    e.trace(exc)
                    e.exit()
                    raise
                if resp.status_code >= 500:
                    e.trace(RuntimeError(f"http {resp.status_code}"))
                e.exit()
                return resp

        return _Session(**kw)


def guarded_urlopen(sentinel, url, *args,
                    resource_extractor: Optional[Callable] = None,
                    **kwargs):
    """stdlib variant: ``urllib.request.urlopen`` under an entry. Raises
    BlockException when denied (callers treat it like a connection error)."""
    req_url = url.full_url if isinstance(url, urllib.request.Request) else url
    method = (url.get_method()
              if isinstance(url, urllib.request.Request) else "GET")
    resource = (resource_extractor or default_resource)(method, req_url)
    e = sentinel.entry(resource, entry_type=0, resource_type=TYPE_COMMON)
    try:
        resp = urllib.request.urlopen(url, *args, **kwargs)
    except BaseException as exc:
        e.trace(exc)
        e.exit()
        raise
    e.exit()
    return resp


def SentinelAiohttpSession(sentinel, *,
                           resource_extractor: Optional[Callable[[str, str],
                                                                 str]] = None,
                           **kw):
    """An ``aiohttp.ClientSession`` guarding every outbound request —
    the async-client analog of :class:`SentinelSession` (reference
    ``sentinel-spring-webflux-adapter`` WebClient integration: entry
    before the exchange, block surfaces as the request's exception,
    5xx and transport errors trace into the exception stats).

    Deny raises :class:`BlockException` from the ``await``; a pacing
    wait is awaited on the event loop, never slept (the entry lifecycle
    — pacing await, cancellation safety, trace-on-exception, exit —
    rides :class:`~sentinel_tpu_torch.adapters.asyncio_support.async_entry`).
    Defined lazily so importing this module never requires aiohttp.

    Entry-exit timing (PINNED, diverges from the WebFlux reference):
    the entry exits at HEADERS time — when ``_request`` returns the
    response object — not when the body is released/closed. RT and the
    live-concurrency gauge therefore cover connect + request + first
    response byte, excluding body streaming; the WebFlux adapter's
    ``doFinally`` covers the full exchange including the body. Rationale
    + migration notes in docs/MIGRATION.md ("aiohttp client entry
    window"); behavior pinned by
    tests/test_aiohttp_adapter.py::test_entry_exits_at_headers_time."""
    import warnings

    import aiohttp

    from sentinel_tpu_torch.adapters.asyncio_support import async_entry

    # aiohttp deprecates ClientSession subclassing, but overriding
    # _request is the only seam that keeps the whole request API intact
    # (session.get(...) stays awaitable AND an async context manager);
    # a composition wrapper would lose that dual protocol
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)

        class _Session(aiohttp.ClientSession):
            async def _request(self, method, str_or_url, **k):
                resource = (resource_extractor or default_resource)(
                    str(method), str(str_or_url))
                async with async_entry(sentinel, resource, entry_type=0,
                                       resource_type=TYPE_COMMON) as e:
                    resp = await super()._request(method, str_or_url, **k)
                    if resp.status >= 500:
                        e.trace(RuntimeError(f"http {resp.status}"))
                    return resp

    return _Session(**kw)
