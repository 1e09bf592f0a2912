"""HTTP command frontend (reference
``sentinel-transport-simple-http/.../SimpleHttpCommandCenter.java``).

A threaded stdlib HTTP server on the API port (default 8719) that parses
``GET /commandName?k=v`` and ``POST`` form bodies into
:class:`CommandRequest` and dispatches into the :class:`CommandCenter`.
Port conflicts auto-increment like the reference (tryServerSocket loop,
``SimpleHttpCommandCenter.java:48-80``).

The PyTorch port's own copy of ``sentinel_tpu/transport/http_server.py``.
"""

from __future__ import annotations

import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from sentinel_tpu_torch.transport.command import (
    CommandCenter, CommandRequest, CommandResponse,
)

MAX_PORT_ATTEMPTS = 3  # PORT_UNINITIALIZED retry count in the reference


class _Handler(BaseHTTPRequestHandler):
    center: CommandCenter  # set on the subclass by SimpleHttpCommandCenter
    protocol_version = "HTTP/1.1"

    def _dispatch(self, body: bytes) -> None:
        parsed = urllib.parse.urlparse(self.path)
        name = parsed.path.strip("/")
        params = {k: v[-1] for k, v in
                  urllib.parse.parse_qs(parsed.query).items()}
        ctype = self.headers.get("Content-Type", "")
        if body and "application/x-www-form-urlencoded" in ctype:
            try:
                decoded = body.decode("utf-8")
            except UnicodeDecodeError:
                resp = CommandResponse.of_failure("invalid request body", 400)
                payload = resp.result.encode("utf-8")
                self.send_response(400)
                self.send_header("Content-Type", "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            for k, v in urllib.parse.parse_qs(decoded).items():
                params[k] = v[-1]
        if not name:
            resp = CommandResponse.of_failure(
                "Command name cannot be empty", 400)
        else:
            resp = self.center.handle(
                name, CommandRequest(parameters=params, body=body))
        payload = resp.result.encode("utf-8")
        self.send_response(resp.code if not resp.success else 200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802
        self._dispatch(b"")

    def do_POST(self) -> None:  # noqa: N802
        length = int(self.headers.get("Content-Length", "0") or 0)
        self._dispatch(self.rfile.read(length) if length else b"")

    def log_message(self, fmt, *args):  # quiet; RecordLog covers diagnostics
        pass


class SimpleHttpCommandCenter:
    """Owns the server thread; ``port`` reflects the actually-bound port."""

    def __init__(self, center: CommandCenter, host: str = "0.0.0.0",
                 port: int = 8719):
        self.center = center
        self.host = host
        self.requested_port = port
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        handler = type("BoundHandler", (_Handler,), {"center": self.center})
        last_err: Optional[OSError] = None
        for attempt in range(MAX_PORT_ATTEMPTS):
            try:
                self._server = ThreadingHTTPServer(
                    (self.host, self.requested_port + attempt), handler)
                break
            except OSError as exc:
                last_err = exc
        if self._server is None:
            raise OSError(
                f"no free command port in "
                f"[{self.requested_port}, {self.requested_port + MAX_PORT_ATTEMPTS})"
            ) from last_err
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="sentinel-command-center")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
