"""The cluster token server, in front of the engine on the GPU.

Reference: ``SentinelDefaultTokenServer`` + ``NettyTransportServer`` +
``TokenServerHandler`` + ``ConnectionManager`` (sentinel-cluster-server-default,
SURVEY §2.3/§3.3). The host process fronts the sharded device engine
(:class:`sentinel_tpu_torch.parallel.cluster.ClusterEngine`): requests arriving
within a small batching window are decided in ONE device step — the wire
protocol is the reference's exact binary framing, so Java Sentinel clients
can point at this server unchanged.

Pieces:

* asyncio TCP server (default port 18730) speaking the framed codec;
* PING → namespace registration (``ConnectionManager.addConnection``), which
  feeds per-namespace ``connectedCount`` into AVG_LOCAL thresholds;
* FLOW / PARAM_FLOW → micro-batched into ``engine.request_tokens`` /
  ``request_param_tokens`` (the batcher is the device's answer to per-request
  Netty handlers: decisions amortize the host→device hop);
* CONCURRENT acquire/release → host :class:`ConcurrentTokenManager`, with a
  periodic lease sweep (``RegularExpireStrategy``);
* idle-connection reaper (``ScanIdleConnectionTask``).

The PyTorch port of ``sentinel_tpu/cluster/server.py``; its per-second
rollup goes to ``sentinel-cluster-server.log`` through the port's
:class:`~sentinel_tpu_torch.core.logs.BlockStatLogger`.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from sentinel_tpu_torch.cluster import codec
from sentinel_tpu_torch.core.clock import Clock
from sentinel_tpu_torch.parallel.cluster import (
    ClusterEngine, ClusterFlowRule, ClusterParamFlowRule,
)
from sentinel_tpu_torch.parallel.concurrent import (
    ConcurrentFlowRule, ConcurrentTokenManager,
)

DEFAULT_IDLE_SECONDS = 600          # ServerTransportConfig default idleSeconds
DEFAULT_BATCH_WINDOW_MS = 1.0       # micro-batch collection window
DEFAULT_EXPIRE_SWEEP_MS = 1000


class _Conn:
    def __init__(self, writer: asyncio.StreamWriter, peer: str):
        self.writer = writer
        self.peer = peer
        self.namespace: Optional[str] = None
        self.last_active = time.monotonic()


class ClusterTokenServer:
    """Standalone (or embedded-alongside-app) token server.

    ``embedded`` mode in the reference means the server shares a JVM with a
    client app (``SentinelDefaultTokenServer.embedded``); here it simply means
    constructing this object inside an app process — there is no separate
    binary.
    """

    def __init__(self, engine: ClusterEngine,
                 concurrent: Optional[ConcurrentTokenManager] = None,
                 *, clock: Optional[Clock] = None,
                 host: str = "0.0.0.0",
                 port: int = codec.DEFAULT_CLUSTER_SERVER_PORT,
                 idle_seconds: float = DEFAULT_IDLE_SECONDS,
                 batch_window_ms: float = DEFAULT_BATCH_WINDOW_MS,
                 log_dir: Optional[str] = None):
        if getattr(engine, "_multiprocess", False):
            # Socket-driven stepping from ONE process would leave the
            # other processes out of the collective step; multi-process
            # engines must be driven on every process (multihost/ingest),
            # and the reference refuses them here too (ROADMAP A11).
            raise ValueError(
                "ClusterTokenServer cannot front an engine spread over "
                "several processes (as in the reference; ROADMAP A11)")
        self.engine = engine
        self.concurrent = concurrent or ConcurrentTokenManager()
        self.clock = clock or Clock()
        self.host = host
        self.port = port
        self.idle_seconds = idle_seconds
        self.batch_window_ms = batch_window_ms
        # ClusterServerStatLogUtil → cluster-server.log: per-second rollup
        # of grant/deny counts per flow id (EagleEye StatLogger analog;
        # file IO rides the async appender's flush daemon)
        from sentinel_tpu_torch.core.logs import BlockStatLogger
        self.stat_log = BlockStatLogger(
            self.clock, base_dir=log_dir,
            file_name="sentinel-cluster-server.log")

        self._conns: Set[_Conn] = set()
        self._ns_conns: Dict[str, Set[str]] = {}
        self._concurrent_ns: Dict[str, Set[int]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stopping = False
        # start-attempt epoch: a boot thread abandoned by start()'s timeout
        # must not publish its loop/server over a newer attempt's (the
        # transport-config rollback would otherwise signal the wrong loop)
        self._epoch = 0
        self._state_lock = threading.Lock()
        # micro-batch queues: (request, conn, future-resolution callback)
        self._flow_q: List[Tuple[codec.Request, _Conn]] = []
        self._param_q: List[Tuple[codec.Request, _Conn]] = []
        self._q_event: Optional[asyncio.Event] = None

    # ------------------------------------------------------------------
    # Rule management passthroughs (ClusterFlowRuleManager surface)
    # ------------------------------------------------------------------

    def load_flow_rules(self, namespace: str,
                        rules: Sequence[ClusterFlowRule]) -> None:
        self.engine.load_rules(namespace, rules)

    def load_param_rules(self, namespace: str,
                         rules: Sequence[ClusterParamFlowRule]) -> None:
        self.engine.load_param_rules(namespace, rules)

    def load_concurrent_rules(self, namespace: str,
                              rules: Sequence[ConcurrentFlowRule]) -> None:
        self._concurrent_ns[namespace] = {r.flow_id for r in rules}
        self.concurrent.load_rules(rules)
        self._sync_connected(namespace)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def update_transport_config(self, port: Optional[int] = None,
                                idle_seconds: Optional[float] = None) -> None:
        """Live transport-config change — the ``ServerTransportConfig``
        watcher (``SentinelDefaultTokenServer.java:37-111``: the reference
        stops and restarts the netty server when the port changes). An
        idle-seconds change applies immediately (the reaper reads it per
        sweep); a port change restarts the listener, dropping connections
        exactly like the reference restart — clients re-register via their
        2 s reconnect loop."""
        if idle_seconds is not None:
            self.idle_seconds = float(idle_seconds)
        if port is not None and int(port) != self.port:
            running = self._thread is not None
            old_port = self.port
            if running:
                self.stop()
            self.port = int(port)
            if running:
                try:
                    self.start()
                except Exception:
                    # the new port didn't bind: restore service on the old
                    # one rather than staying down (clients are still
                    # reconnecting to it)
                    self._thread = None
                    self._loop = None
                    self.port = old_port
                    self.start()
                    raise

    def start(self) -> None:
        """Run the server on a daemon thread; returns once listening. A bind
        failure (port in use) surfaces immediately — the boot exception is
        handed back through ``_boot_error`` rather than waiting out the
        10 s timeout, so a transport-config restart's rollback window stays
        at milliseconds."""
        if self._thread is not None:
            return
        self._boot_error: Optional[BaseException] = None
        epoch = self._epoch
        self._thread = threading.Thread(target=self._run, args=(epoch,),
                                        daemon=True,
                                        name="sentinel-cluster-server")
        self._thread.start()
        if not self._started.wait(timeout=10):
            with self._state_lock:
                self._epoch += 1     # the late boot must not publish
            self._thread = None
            raise RuntimeError("cluster token server failed to start")
        if self._boot_error is not None:
            self._thread.join(timeout=1)
            self._thread = None
            self._loop = None
            self._started.clear()
            exc, self._boot_error = self._boot_error, None
            raise RuntimeError(
                f"cluster token server failed to start: {exc}") from exc

    def stop(self) -> None:
        if self._loop is None:
            return
        self._stopping = True
        loop = self._loop
        fut = asyncio.run_coroutine_threadsafe(self._shutdown(), loop)
        fut.result(timeout=10)
        loop.call_soon_threadsafe(loop.stop)
        if self._thread:
            self._thread.join(timeout=10)
        self._thread = None
        self._loop = None
        self._started.clear()
        self._stopping = False

    async def _shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
        for c in list(self._conns):
            c.writer.close()
        await asyncio.sleep(0)  # let handler tasks observe the closes

    def _run(self, epoch: int) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def boot():
            return await asyncio.start_server(
                self._handle_conn, self.host, self.port)

        try:
            server = loop.run_until_complete(boot())
        except BaseException as exc:    # bind failure → report, clean up
            with self._state_lock:
                if self._epoch == epoch:
                    self._boot_error = exc
                    self._started.set()
            loop.close()
            return
        with self._state_lock:
            if self._epoch != epoch:
                # start() timed this attempt out and moved on (e.g. the
                # rollback server is already up) — release the socket and
                # vanish without touching published state
                abandoned = True
            else:
                abandoned = False
                self._loop = loop
                self._server = server
                self._q_event = asyncio.Event()
                if self.port == 0:
                    self.port = server.sockets[0].getsockname()[1]
        if abandoned:
            server.close()
            try:
                loop.run_until_complete(server.wait_closed())
            except Exception:
                pass
            loop.close()
            return
        loop.create_task(self._batch_loop())
        loop.create_task(self._sweep_loop())
        loop.create_task(self._idle_loop())
        self._started.set()
        try:
            loop.run_forever()
        finally:
            for task in asyncio.all_tasks(loop):
                task.cancel()
            try:
                loop.run_until_complete(asyncio.sleep(0))
            except Exception:
                pass
            loop.close()

    # ------------------------------------------------------------------
    # Connection handling
    # ------------------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        peer = "%s:%s" % (writer.get_extra_info("peername") or ("?", 0))[:2]
        conn = _Conn(writer, peer)
        self._conns.add(conn)
        assembler = codec.FrameAssembler()
        try:
            while True:
                data = await reader.read(4096)
                if not data:
                    break
                conn.last_active = time.monotonic()
                for frame in assembler.feed(data):
                    await self._dispatch(frame, conn)
        except (ConnectionResetError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            self._drop_conn(conn)
            writer.close()

    def _drop_conn(self, conn: _Conn) -> None:
        self._conns.discard(conn)
        if conn.namespace is not None:
            group = self._ns_conns.get(conn.namespace)
            if group is not None:
                group.discard(conn.peer)
                self._sync_connected(conn.namespace)

    def _sync_connected(self, namespace: str) -> None:
        count = max(1, len(self._ns_conns.get(namespace, ())))
        self.engine.set_connected_count(namespace, count)
        for fid in self._concurrent_ns.get(namespace, ()):
            self.concurrent.set_connected_count(fid, count)

    async def _dispatch(self, frame: bytes, conn: _Conn) -> None:
        try:
            req = codec.decode_request(frame)
        except Exception:
            # malformed payload (bad TLV, truncated data): the reference's
            # decoder just drops the frame; subsequent frames stay usable
            return
        if req is None:
            return
        t = req.type
        if t == codec.MSG_TYPE_PING:
            ns = str(req.data or "default")
            if conn.namespace is not None and conn.namespace != ns:
                # re-registration: leave the old namespace group first
                old = self._ns_conns.get(conn.namespace)
                if old is not None:
                    old.discard(conn.peer)
                    self._sync_connected(conn.namespace)
            conn.namespace = ns
            self._ns_conns.setdefault(ns, set()).add(conn.peer)
            self._sync_connected(ns)
            await self._send(conn, codec.Response(
                req.xid, t, codec.RESPONSE_STATUS_OK,
                len(self._ns_conns.get(ns, ()))))
        elif t == codec.MSG_TYPE_FLOW:
            self._flow_q.append((req, conn))
            self._q_event.set()
        elif t == codec.MSG_TYPE_PARAM_FLOW:
            self._param_q.append((req, conn))
            self._q_event.set()
        elif t == codec.MSG_TYPE_CONCURRENT_FLOW_ACQUIRE:
            flow_id, count, _prio = req.data
            status, token_id = self.concurrent.acquire(
                flow_id, count, client_address=conn.peer,
                now_ms=self.clock.now_ms())
            await self._send(conn, codec.Response(req.xid, t, status, token_id))
        elif t == codec.MSG_TYPE_CONCURRENT_FLOW_RELEASE:
            status = self.concurrent.release(int(req.data))
            await self._send(conn, codec.Response(req.xid, t, status))
        else:
            await self._send(conn, codec.Response(
                req.xid, t, codec.RESPONSE_STATUS_BAD))

    async def _send(self, conn: _Conn, resp: codec.Response) -> None:
        try:
            conn.writer.write(codec.encode_response(resp))
            await conn.writer.drain()
        except (ConnectionResetError, RuntimeError):
            self._drop_conn(conn)

    # ------------------------------------------------------------------
    # Micro-batched token decisions
    # ------------------------------------------------------------------

    async def _batch_loop(self) -> None:
        while True:
            await self._q_event.wait()
            # collect for one batching window, then decide in one device step
            if self.batch_window_ms > 0:
                await asyncio.sleep(self.batch_window_ms / 1000.0)
            self._q_event.clear()
            flow_q, self._flow_q = self._flow_q, []
            param_q, self._param_q = self._param_q, []
            now_ms = self.clock.now_ms()
            if flow_q:
                reqs = [r for r, _ in flow_q]
                res = await asyncio.to_thread(
                    self.engine.request_tokens,
                    [r.data[0] for r in reqs], [r.data[1] for r in reqs],
                    [r.data[2] for r in reqs], now_ms=now_ms)
                for (req, conn), (status, wait_ms, remaining) in zip(flow_q, res):
                    self.stat_log.log(f"flow-{req.data[0]}",
                                      "pass" if status in (0, 2) else "block",
                                      origin=conn.namespace or "")
                    await self._send(conn, codec.Response(
                        req.xid, req.type, status, (remaining, wait_ms)))
            if param_q:
                reqs = [r for r, _ in param_q]
                res = await asyncio.to_thread(
                    self.engine.request_param_tokens,
                    [r.data[0] for r in reqs], [r.data[1] for r in reqs],
                    [r.data[2] for r in reqs], now_ms=now_ms)
                for (req, conn), (status, wait_ms, remaining) in zip(param_q, res):
                    self.stat_log.log(f"param-{req.data[0]}",
                                      "pass" if status in (0, 2) else "block",
                                      origin=conn.namespace or "")
                    await self._send(conn, codec.Response(
                        req.xid, req.type, status, (remaining, wait_ms)))

    async def _sweep_loop(self) -> None:
        """RegularExpireStrategy: reclaim expired concurrent leases."""
        while True:
            await asyncio.sleep(DEFAULT_EXPIRE_SWEEP_MS / 1000.0)
            self.concurrent.sweep_expired(now_ms=self.clock.now_ms())

    async def _idle_loop(self) -> None:
        """ScanIdleConnectionTask: close connections idle beyond the limit."""
        while True:
            await asyncio.sleep(min(30.0, self.idle_seconds / 2 + 0.01))
            cutoff = time.monotonic() - self.idle_seconds
            for c in list(self._conns):
                if c.last_active < cutoff:
                    c.writer.close()
                    self._drop_conn(c)

    # ------------------------------------------------------------------
    def connection_count(self, namespace: str) -> int:
        return len(self._ns_conns.get(namespace, ()))
