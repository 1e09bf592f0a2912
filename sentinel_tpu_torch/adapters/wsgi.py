"""WSGI middleware (reference ``sentinel-web-servlet`` ``CommonFilter`` +
``WebCallbackManager``: URL cleaner, origin parser, block page).

Resource name defaults to ``METHOD:path`` (the reference's
``HttpMethodSpecify`` mode); a ``url_cleaner`` collapses dynamic segments
(``/order/123`` → ``/order/{id}``) so resource cardinality stays bounded —
the reference's ``UrlCleaner`` interface. Blocks return 429 with a plain
body by default (``DefaultBlockExceptionHandler``), customizable via
``block_handler(environ, start_response, exc)``.

The PyTorch port's own copy of ``sentinel_tpu/adapters/wsgi.py``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from sentinel_tpu_torch.core.context import ContextScope
from sentinel_tpu_torch.core.errors import BlockException
from sentinel_tpu_torch.metrics.node import TYPE_WEB

WEB_CONTEXT_NAME = "sentinel_web_context"   # CommonFilter WEB_CONTEXT_UNIFY


def default_block_response(environ, start_response, exc) -> Iterable[bytes]:
    body = b"Blocked by Sentinel (flow limiting)"
    start_response("429 Too Many Requests", [
        ("Content-Type", "text/plain; charset=utf-8"),
        ("Content-Length", str(len(body)))])
    return [body]


class SentinelWSGIMiddleware:
    def __init__(self, app, sentinel, *,
                 resource_extractor: Optional[Callable] = None,
                 url_cleaner: Optional[Callable[[str], str]] = None,
                 origin_parser: Optional[Callable] = None,
                 block_handler: Optional[Callable] = None,
                 http_method_specify: bool = True,
                 context_name: str = WEB_CONTEXT_NAME):
        self.app = app
        self.sentinel = sentinel
        self.resource_extractor = resource_extractor
        self.url_cleaner = url_cleaner
        self.origin_parser = origin_parser
        self.block_handler = block_handler or default_block_response
        self.http_method_specify = http_method_specify
        self.context_name = context_name

    def _resource(self, environ) -> str:
        if self.resource_extractor is not None:
            return self.resource_extractor(environ)
        path = environ.get("PATH_INFO", "/") or "/"
        if self.url_cleaner is not None:
            path = self.url_cleaner(path)
        if not path:
            return ""          # empty → pass through unguarded (reference)
        if self.http_method_specify:
            return f"{environ.get('REQUEST_METHOD', 'GET')}:{path}"
        return path

    def __call__(self, environ, start_response):
        resource = self._resource(environ)
        if not resource:
            return self.app(environ, start_response)
        origin = (self.origin_parser(environ)
                  if self.origin_parser is not None else "")
        with ContextScope(self.context_name, origin=origin):
            try:
                entry = self.sentinel.entry(resource, entry_type=1,
                                            resource_type=TYPE_WEB)
            except BlockException as exc:
                return self.block_handler(environ, start_response, exc)
            try:
                result = self.app(environ, start_response)
            except BaseException as exc:
                entry.trace(exc)
                entry.exit()
                raise
            entry.exit()
            return result
