"""ASGI 3 middleware (reference ``sentinel-spring-webflux-adapter`` /
``sentinel-reactor-adapter``: the async-pipeline variant of the web filter).

Same resource naming as the WSGI middleware; pacing waits are awaited with
``asyncio.sleep`` instead of blocking the event loop (the reactor adapter's
AsyncEntry pattern — the verdict carries ``wait_ms`` and the subscriber
honors it asynchronously).

The PyTorch port's own copy of ``sentinel_tpu/adapters/asgi.py``.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from sentinel_tpu_torch.core.context import ContextScope
from sentinel_tpu_torch.core.errors import BlockException
from sentinel_tpu_torch.metrics.node import TYPE_WEB

from sentinel_tpu_torch.adapters.wsgi import WEB_CONTEXT_NAME


class SentinelASGIMiddleware:
    def __init__(self, app, sentinel, *,
                 url_cleaner: Optional[Callable[[str], str]] = None,
                 origin_parser: Optional[Callable[[dict], str]] = None,
                 http_method_specify: bool = True,
                 block_status: int = 429,
                 block_body: bytes = b"Blocked by Sentinel (flow limiting)",
                 context_name: str = WEB_CONTEXT_NAME):
        self.app = app
        self.sentinel = sentinel
        self.url_cleaner = url_cleaner
        self.origin_parser = origin_parser
        self.http_method_specify = http_method_specify
        self.block_status = block_status
        self.block_body = block_body
        self.context_name = context_name

    async def _blocked(self, send) -> None:
        await send({"type": "http.response.start",
                    "status": self.block_status,
                    "headers": [(b"content-type",
                                 b"text/plain; charset=utf-8")]})
        await send({"type": "http.response.body", "body": self.block_body})

    async def __call__(self, scope, receive, send):
        if scope["type"] != "http":
            await self.app(scope, receive, send)
            return
        path = scope.get("path", "/") or "/"
        if self.url_cleaner is not None:
            path = self.url_cleaner(path)
        if not path:
            await self.app(scope, receive, send)
            return
        resource = (f"{scope.get('method', 'GET')}:{path}"
                    if self.http_method_specify else path)
        origin = (self.origin_parser(scope)
                  if self.origin_parser is not None else "")
        with ContextScope(self.context_name, origin=origin):
            try:
                entry = self.sentinel.entry(resource, entry_type=1,
                                            resource_type=TYPE_WEB,
                                            sleep=False)
            except BlockException:
                await self._blocked(send)
                return
        try:
            if entry.wait_ms > 0:   # pacing: await, don't block the loop
                await asyncio.sleep(entry.wait_ms / 1000.0)
            await self.app(scope, receive, send)
        except BaseException as exc:
            entry.trace(exc)        # incl. CancelledError on disconnect —
            entry.exit()            # the entry must not leak concurrency
            raise
        entry.exit()
