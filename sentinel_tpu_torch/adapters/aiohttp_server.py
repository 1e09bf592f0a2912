"""aiohttp server middleware (reference ``sentinel-spring-webmvc-adapter``
``SentinelWebInterceptor`` shape, on aiohttp's middleware chain).

Usage::

    app = web.Application(middlewares=[sentinel_middleware(sph)])

The PyTorch port's own copy of ``sentinel_tpu/adapters/aiohttp_server.py``.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from aiohttp import web

from sentinel_tpu_torch.core.context import ContextScope
from sentinel_tpu_torch.core.errors import BlockException
from sentinel_tpu_torch.metrics.node import TYPE_WEB

from sentinel_tpu_torch.adapters.wsgi import WEB_CONTEXT_NAME


def sentinel_middleware(sentinel, *,
                        url_cleaner: Optional[Callable[[str], str]] = None,
                        origin_parser: Optional[Callable] = None,
                        http_method_specify: bool = True,
                        block_status: int = 429,
                        context_name: str = WEB_CONTEXT_NAME):
    @web.middleware
    async def middleware(request: web.Request, handler):
        path = request.path or "/"
        if url_cleaner is not None:
            path = url_cleaner(path)
        if not path:
            return await handler(request)
        resource = (f"{request.method}:{path}"
                    if http_method_specify else path)
        origin = origin_parser(request) if origin_parser is not None else ""
        with ContextScope(context_name, origin=origin):
            try:
                entry = sentinel.entry(resource, entry_type=1,
                                       resource_type=TYPE_WEB, sleep=False)
            except BlockException:
                return web.Response(
                    status=block_status,
                    text="Blocked by Sentinel (flow limiting)")
        try:
            if entry.wait_ms > 0:
                await asyncio.sleep(entry.wait_ms / 1000.0)
            resp = await handler(request)
        except BaseException as exc:
            entry.trace(exc)        # incl. CancelledError on disconnect
            entry.exit()
            raise
        entry.exit()
        return resp

    return middleware
