"""Asyncio HTTP command frontend — the nonblocking command-transport
variant (reference ``sentinel-transport-netty-http/.../
NettyHttpCommandCenter.java:36`` + ``HttpServerHandler``: an event-loop
server beside the thread-per-connection simple-http one).

Why it exists: the threaded :class:`SimpleHttpCommandCenter` dedicates a
thread per connection, so a handful of slow-loris clients (bytes trickling
into the header parser) pin the pool and starve the ops surface. Here one
event loop multiplexes all connections; per-connection READ DEADLINES and
size caps bound what any client can hold open, and command handlers run in
a small executor so a blocking handler can't stall the loop.

Same dispatch contract as the threaded server: ``GET /command?k=v`` and
``POST`` form bodies → :class:`CommandRequest` → ``CommandCenter.handle``.
Port conflicts auto-increment (``SimpleHttpCommandCenter.java:48-80``).

The PyTorch port's own copy of ``sentinel_tpu/transport/async_http_server.py``.
"""

from __future__ import annotations

import asyncio
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from sentinel_tpu_torch.transport.command import (
    CommandCenter, CommandRequest, CommandResponse,
)
from sentinel_tpu_torch.transport.http_server import MAX_PORT_ATTEMPTS

MAX_HEADER_BYTES = 16 * 1024
MAX_BODY_BYTES = 4 * 1024 * 1024
READ_TIMEOUT_S = 10.0       # slow-loris bound: full request must arrive
KEEPALIVE_TIMEOUT_S = 30.0  # idle keep-alive connections are reaped


class AsyncHttpCommandCenter:
    """Owns the event loop thread; ``port`` reflects the bound port."""

    def __init__(self, center: CommandCenter, host: str = "0.0.0.0",
                 port: int = 8719, read_timeout_s: float = READ_TIMEOUT_S,
                 max_workers: int = 4):
        self.center = center
        self.host = host
        self.requested_port = port
        self.port: Optional[int] = None
        self.read_timeout_s = read_timeout_s
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="sentinel-async-cmd")
        self._started = threading.Event()
        self._start_err: Optional[BaseException] = None

    # ---------------- connection handling (on the loop) ----------------

    async def _read_request(self, reader: asyncio.StreamReader,
                            first: bool):
        """→ (method, path, headers, body) or None on clean EOF."""
        # the request LINE may wait (keep-alive idle), but once bytes flow
        # the whole head must arrive within read_timeout_s
        line = await asyncio.wait_for(
            reader.readline(),
            KEEPALIVE_TIMEOUT_S if not first else self.read_timeout_s)
        if not line:
            return None
        async def _head():
            headers = {}
            total = len(line)
            while True:
                h = await reader.readline()
                total += len(h)
                if total > MAX_HEADER_BYTES:
                    raise ValueError("header too large")
                if h in (b"\r\n", b"\n", b""):
                    return headers
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
        headers = await asyncio.wait_for(_head(), self.read_timeout_s)
        try:
            method, path, _ = line.decode("latin-1").split(None, 2)
        except ValueError:
            raise ValueError("bad request line")
        length = int(headers.get("content-length", "0") or 0)
        if length > MAX_BODY_BYTES:
            raise ValueError("body too large")
        body = b""
        if length:
            body = await asyncio.wait_for(reader.readexactly(length),
                                          self.read_timeout_s)
        return method, path, headers, body

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            first = True
            while True:
                try:
                    req = await self._read_request(reader, first)
                except (asyncio.TimeoutError, ValueError,
                        asyncio.IncompleteReadError):
                    break               # slow/malformed client: reap it
                if req is None:
                    break
                first = False
                method, path, headers, body = req
                parsed = urllib.parse.urlparse(path)
                name = parsed.path.strip("/")
                params = {k: v[-1] for k, v in
                          urllib.parse.parse_qs(parsed.query).items()}
                ctype = headers.get("content-type", "")
                bad = None
                if body and "application/x-www-form-urlencoded" in ctype:
                    try:
                        for k, v in urllib.parse.parse_qs(
                                body.decode("utf-8")).items():
                            params[k] = v[-1]
                    except UnicodeDecodeError:
                        bad = CommandResponse.of_failure(
                            "invalid request body", 400)
                if bad is not None:
                    resp = bad
                elif not name:
                    resp = CommandResponse.of_failure(
                        "Command name cannot be empty", 400)
                else:
                    # handlers may block (engine locks, device steps):
                    # keep the loop free. CommandCenter.handle already
                    # converts handler exceptions to 500 responses; this
                    # catch covers only executor-infrastructure failures
                    # (e.g. pool shutdown during stop()) so the client
                    # still gets a response instead of a dropped
                    # connection + unretrieved-exception traceback.
                    try:
                        resp = await asyncio.get_running_loop() \
                            .run_in_executor(
                                self._pool, self.center.handle, name,
                                CommandRequest(parameters=params,
                                               body=body))
                    except Exception as exc:
                        resp = CommandResponse.of_failure(
                            f"command handler error: {exc!r}", 500)
                payload = resp.result.encode("utf-8")
                code = resp.code if not resp.success else 200
                keep = headers.get("connection", "keep-alive") != "close"
                head = (f"HTTP/1.1 {code} X\r\n"
                        f"Content-Type: text/plain; charset=utf-8\r\n"
                        f"Content-Length: {len(payload)}\r\n"
                        f"Connection: {'keep-alive' if keep else 'close'}"
                        f"\r\n\r\n")
                writer.write(head.encode("latin-1") + payload)
                await writer.drain()
                if not keep:
                    break
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    # ---------------- lifecycle (host threads) ----------------

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)

        async def _start():
            last: Optional[OSError] = None
            for attempt in range(MAX_PORT_ATTEMPTS):
                try:
                    return await asyncio.start_server(
                        self._handle_conn, self.host,
                        self.requested_port + attempt)
                except OSError as exc:
                    last = exc
            raise OSError(
                f"no free command port in [{self.requested_port}, "
                f"{self.requested_port + MAX_PORT_ATTEMPTS})") from last

        try:
            self._server = loop.run_until_complete(_start())
            self.port = self._server.sockets[0].getsockname()[1]
        except BaseException as exc:
            self._start_err = exc
            self._started.set()
            loop.close()
            return
        self._started.set()
        try:
            loop.run_forever()
        finally:
            self._server.close()
            loop.run_until_complete(self._server.wait_closed())
            loop.close()

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._run_loop, daemon=True,
            name="sentinel-async-command-center")
        self._thread.start()
        self._started.wait(timeout=10)
        if self._start_err is not None:
            raise self._start_err
        assert self.port is not None
        return self.port

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._thread is not None:
                self._thread.join(timeout=5)
            self._loop = None
        self._pool.shutdown(wait=False)
