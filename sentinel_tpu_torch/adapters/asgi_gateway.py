"""Gateway ASGI middleware (reference
``sentinel-spring-cloud-gateway-adapter``'s ``SentinelGatewayFilter``
rebuilt for Python ASGI gateways).

Per request: resolve the route resource (default: the path, override with
``route_resolver`` for real gateways with named routes), match API groups
through the :class:`~sentinel_tpu_torch.gateway.api.GatewayApiDefinitionManager`
(`GatewayApiMatcherManager` analog), parse the gateway rules' request
attributes (IP / host / header / URL param / cookie) from the ASGI scope,
and open one entry per matched resource — route first, then API groups —
with ``resource_type`` GATEWAY. A denial answers 429 before the app runs.

The PyTorch port's copy of ``sentinel_tpu/adapters/asgi_gateway.py``.
"""

from __future__ import annotations

import asyncio
import urllib.parse
from typing import Callable, List, Optional, Tuple

from sentinel_tpu_torch.core.context import ContextScope
from sentinel_tpu_torch.core.errors import BlockException
from sentinel_tpu_torch.metrics.node import TYPE_GATEWAY

WEB_CONTEXT_NAME = "sentinel_gateway_context"
RESOURCE_MODE_ROUTE_ID = 0
RESOURCE_MODE_CUSTOM_API_NAME = 1


class AsgiRequestItemParser:
    """``RequestItemParser`` over an ASGI http scope."""

    def get_path(self, scope) -> str:
        return scope.get("path", "/") or "/"

    def get_remote_address(self, scope) -> Optional[str]:
        client = scope.get("client")
        return client[0] if client else None

    def get_header(self, scope, key: str) -> Optional[str]:
        want = key.lower().encode("latin-1")
        for k, v in scope.get("headers", []):
            if k.lower() == want:
                return v.decode("latin-1")
        return None

    def get_url_param(self, scope, name: str) -> Optional[str]:
        qs = scope.get("query_string", b"").decode("latin-1")
        vals = urllib.parse.parse_qs(qs).get(name)
        return vals[-1] if vals else None

    def get_cookie_value(self, scope, name: str) -> Optional[str]:
        cookie = self.get_header(scope, "cookie") or ""
        for part in cookie.split(";"):
            k, _, v = part.strip().partition("=")
            if k == name:
                return v
        return None


class SentinelGatewayASGIMiddleware:
    def __init__(self, app, sentinel, gateway_manager,
                 api_definition_manager=None, *,
                 route_resolver: Optional[Callable[[dict], str]] = None,
                 origin_parser: Optional[Callable[[dict], str]] = None,
                 block_status: int = 429,
                 block_body: bytes = b"Blocked by Sentinel (gateway flow)",
                 context_name: str = WEB_CONTEXT_NAME):
        from sentinel_tpu_torch.gateway.param import GatewayParamParser

        self.app = app
        self.sentinel = sentinel
        self.gateway_manager = gateway_manager
        self.api_manager = api_definition_manager
        self.route_resolver = route_resolver or (
            lambda scope: scope.get("path", "/") or "/")
        self.origin_parser = origin_parser
        self.block_status = block_status
        self.block_body = block_body
        self.context_name = context_name
        self._parser = GatewayParamParser(
            gateway_manager, item_parser=AsgiRequestItemParser())

    def _resources(self, scope) -> List[Tuple[str, int]]:
        out = [(self.route_resolver(scope), RESOURCE_MODE_ROUTE_ID)]
        if self.api_manager is not None:
            path = scope.get("path", "/") or "/"
            out.extend((name, RESOURCE_MODE_CUSTOM_API_NAME)
                       for name in self.api_manager.matching_apis(path))
        return out

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
        origin = (self.origin_parser(scope)
                  if self.origin_parser is not None else "")
        entries = []
        wait_ms = 0
        with ContextScope(self.context_name, origin=origin):
            try:
                for resource, mode in self._resources(scope):
                    args = self._parser.parse_parameters(
                        resource, scope,
                        rule_predicate=lambda r, m=mode: r.resource_mode == m)
                    e = self.sentinel.entry(resource, entry_type=1,
                                            resource_type=TYPE_GATEWAY,
                                            args=tuple(args), sleep=False)
                    entries.append(e)
                    wait_ms = max(wait_ms, e.wait_ms)
            except BlockException:
                for e in reversed(entries):
                    e.exit()
                await self._blocked(send)
                return
            except BaseException:
                # non-Block failure mid-loop (a raising host gate, an
                # internal error): already-opened entries must not leak
                # concurrency
                for e in reversed(entries):
                    e.exit()
                raise
        try:
            if wait_ms > 0:         # pacing verdict: await, don't block
                await asyncio.sleep(wait_ms / 1000.0)
            await self.app(scope, receive, send)
        except BaseException as exc:
            for e in reversed(entries):
                e.trace(exc)
                e.exit()
            raise
        for e in reversed(entries):
            e.exit()
