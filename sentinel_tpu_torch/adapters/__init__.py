"""Integration adapters (reference ``sentinel-adapter/*``, SURVEY §2.6) —
the PyTorch port of ``sentinel_tpu/adapters``.

Every reference adapter reduces to the same shape: derive a resource name
(+ parse the caller origin), ``ContextUtil.enter``, ``SphU.entry``, invoke,
``Tracer.traceEntry`` on exception, ``entry.exit()``. These are the Python
ecosystem's equivalents:

- :mod:`.decorator` — ``@sentinel_resource`` with block_handler/fallback
  (``sentinel-annotation-aspectj`` ``SentinelResourceAspect``)
- :mod:`.wsgi` — WSGI middleware (``sentinel-web-servlet`` ``CommonFilter``)
- :mod:`.asgi` — ASGI 3 middleware, async (``sentinel-spring-webflux-adapter``)
- :mod:`.grpc_interceptor` — gRPC server/client interceptors
  (``sentinel-grpc-adapter``)
- :mod:`.http_client` — ``requests`` session + ``urllib`` opener guards
  (``sentinel-okhttp-adapter`` / ``sentinel-apache-httpclient-adapter``)
- :mod:`.aiohttp_server` — aiohttp server middleware
  (``sentinel-spring-webmvc-adapter`` ``SentinelWebInterceptor`` shape)
- :mod:`.asyncio_support` — async entry helper (``sentinel-reactor-adapter``
  ``AsyncEntry`` analog for asyncio)
- :mod:`.asgi_gateway` — gateway ASGI middleware: route and API-group
  resources with gateway param rules (``sentinel-spring-cloud-gateway-
  adapter`` ``SentinelGatewayFilter``)

Each guards calls through the :class:`~sentinel_tpu_torch.runtime.Sentinel`
it is given (on ``cuda`` unless built otherwise). ``grpc_interceptor`` and
``aiohttp_server`` import ``grpc`` and ``aiohttp`` at module top, so this
package does not import them; ``http_client`` imports ``requests`` and
``aiohttp`` only inside the session it builds.
"""

from sentinel_tpu_torch.adapters.decorator import sentinel_resource
from sentinel_tpu_torch.adapters.wsgi import SentinelWSGIMiddleware
from sentinel_tpu_torch.adapters.asgi import SentinelASGIMiddleware
from sentinel_tpu_torch.adapters.asyncio_support import async_entry
from sentinel_tpu_torch.adapters.http_client import (
    SentinelAiohttpSession, SentinelSession, guarded_urlopen,
)
from sentinel_tpu_torch.adapters.asgi_gateway import (
    AsgiRequestItemParser, SentinelGatewayASGIMiddleware,
)

__all__ = [
    "sentinel_resource", "SentinelWSGIMiddleware", "SentinelASGIMiddleware",
    "async_entry", "SentinelAiohttpSession", "SentinelSession",
    "guarded_urlopen",
    "AsgiRequestItemParser", "SentinelGatewayASGIMiddleware",
]
