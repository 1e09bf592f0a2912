"""Command surface mounted into a host web app (reference
``sentinel-transport-spring-mvc``'s ``SentinelApiHandlerMapping`` /
``sentinel-transport-netty-http`` — the command center served by the
application's own HTTP stack instead of a dedicated port).

``command_wsgi_app(center)`` returns a WSGI callable and
``command_asgi_app(center)`` an ASGI callable; mount either under a path
prefix of your app (e.g. ``/sentinel``) and point the dashboard's machine
port at the app port. Request semantics match
:class:`~sentinel_tpu_torch.transport.http_server.SimpleHttpCommandCenter`:
command name = URL path, params = query string merged with a
form-encoded body, response = ``text/plain`` command result.

The PyTorch port's own copy of ``sentinel_tpu/transport/mounted.py``.
"""

from __future__ import annotations

import urllib.parse
from typing import Optional

from sentinel_tpu_torch.transport.command import (
    CommandCenter, CommandRequest, CommandResponse,
)


def _run(center: CommandCenter, path: str, query: str, body: bytes,
         ctype: str) -> CommandResponse:
    name = path.strip("/")
    params = {k: v[-1] for k, v in urllib.parse.parse_qs(query).items()}
    if body and "application/x-www-form-urlencoded" in ctype:
        try:
            for k, v in urllib.parse.parse_qs(body.decode("utf-8")).items():
                params[k] = v[-1]
        except UnicodeDecodeError:
            return CommandResponse.of_failure("invalid request body", 400)
    if not name:
        return CommandResponse.of_failure("Command name cannot be empty", 400)
    return center.handle(name, CommandRequest(parameters=params, body=body))


def command_wsgi_app(center: CommandCenter, prefix: str = ""):
    """WSGI app serving the command center. ``prefix`` is stripped from
    ``PATH_INFO`` when the host framework doesn't already do so."""

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "")
        if prefix and path.startswith(prefix):
            path = path[len(prefix):]
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        body = environ["wsgi.input"].read(length) if length else b""
        resp = _run(center, path, environ.get("QUERY_STRING", ""), body,
                    environ.get("CONTENT_TYPE", ""))
        payload = resp.result.encode("utf-8")
        status = "200 OK" if resp.success else f"{resp.code} ERROR"
        start_response(status, [
            ("Content-Type", "text/plain; charset=utf-8"),
            ("Content-Length", str(len(payload)))])
        return [payload]

    return app


def command_asgi_app(center: CommandCenter, prefix: str = ""):
    """ASGI (http-scope) app serving the command center."""

    async def app(scope, receive, send):
        # ASGI frameworks route lifespan (when mounted at an app root) and
        # websocket scopes to mounted apps too — complete/close them cleanly
        # instead of surfacing a server-side exception.
        if scope["type"] == "lifespan":
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] == "websocket":
            await receive()                     # websocket.connect
            await send({"type": "websocket.close", "code": 1000})
            return
        if scope["type"] != "http":
            return                              # unknown scope: ignore
        path = scope.get("path", "")
        if prefix and path.startswith(prefix):
            path = path[len(prefix):]
        body = b""
        while True:
            msg = await receive()
            body += msg.get("body", b"")
            if not msg.get("more_body"):
                break
        headers = {k.decode("latin-1").lower(): v.decode("latin-1")
                   for k, v in scope.get("headers", [])}
        resp = _run(center, path,
                    scope.get("query_string", b"").decode("latin-1"),
                    body, headers.get("content-type", ""))
        payload = resp.result.encode("utf-8")
        await send({"type": "http.response.start",
                    "status": 200 if resp.success else resp.code,
                    "headers": [
                        (b"content-type", b"text/plain; charset=utf-8"),
                        (b"content-length",
                         str(len(payload)).encode("latin-1"))]})
        await send({"type": "http.response.body", "body": payload})

    return app
