"""Cluster token client SDK.

Reference: ``DefaultClusterTokenClient`` + ``NettyTransportClient`` +
``TokenClientPromiseHolder`` (sentinel-cluster-client-default, SURVEY §3.3):
requests are framed with a fresh xid, a promise is parked under that xid, and
the reader completes it when the matching response arrives; the transport
auto-reconnects every 2 s after a drop, and requests time out after 20 ms
(``ClusterConstants.DEFAULT_REQUEST_TIMEOUT``) → callers fall back to local
checks (``FlowRuleChecker.fallbackToLocalOrPass``).

This implementation is a plain blocking-socket client with a daemon reader
thread — it is the *app-side* SDK, deliberately free of device state.
The PyTorch port's own copy of ``sentinel_tpu/cluster/client.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import socket
import struct
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

from sentinel_tpu_torch.cluster import codec
from sentinel_tpu_torch.parallel.cluster import STATUS_FAIL

RECONNECT_DELAY_S = 2.0     # NettyTransportClient.RECONNECT_DELAY_MS
# Failed attempts back off exponentially from RECONNECT_DELAY_S up to this
# cap, with ±25% jitter so a restarted server isn't hit by a synchronized
# reconnect stampede from every client that dropped at the same instant.
RECONNECT_MAX_DELAY_S = 30.0
RECONNECT_JITTER = 0.25


@dataclasses.dataclass
class TokenResult:
    """cluster/TokenResult.java parity."""

    status: int
    remaining: int = 0
    wait_ms: int = 0
    token_id: int = 0

    @property
    def from_server(self) -> bool:
        return True


class ClusterTokenClient:
    """Blocking token client with xid-correlated in-flight requests."""

    def __init__(self, host: str = "127.0.0.1",
                 port: int = codec.DEFAULT_CLUSTER_SERVER_PORT,
                 *, namespace: str = "default",
                 request_timeout_ms: int = codec.DEFAULT_REQUEST_TIMEOUT_MS,
                 connect_timeout_s: float = 10.0,
                 auto_reconnect: bool = True):
        self.host = host
        self.port = port
        self.namespace = namespace
        self.request_timeout_ms = request_timeout_ms
        self.connect_timeout_s = connect_timeout_s
        self.auto_reconnect = auto_reconnect

        self._sock: Optional[socket.socket] = None
        self._xids = itertools.count(1)
        self._pending: Dict[int, Tuple[threading.Event, list]] = {}
        self._lock = threading.Lock()
        self._reader: Optional[threading.Thread] = None
        self._reconnector: Optional[threading.Thread] = None
        self._closed = False
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._connect()
        if self.auto_reconnect and self._reconnector is None:
            self._reconnector = threading.Thread(
                target=self._reconnect_loop, daemon=True,
                name="sentinel-cluster-client-reconnect")
            self._reconnector.start()

    def stop(self) -> None:
        self._closed = True
        self._stop.set()        # interrupt a reconnect backoff immediately
        self._teardown()

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _connect(self) -> None:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout_s)
        sock.settimeout(None)
        self._sock = sock
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="sentinel-cluster-client-reader")
        self._reader.start()
        # register namespace (TokenClientHandler sends PING on activation)
        self.ping()

    def _teardown(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        with self._lock:
            for ev, slot in self._pending.values():
                slot.append(None)
                ev.set()
            self._pending.clear()

    def _reconnect_loop(self) -> None:
        # Interruptible, jittered exponential backoff: a healthy (or
        # freshly re-established) connection keeps the probe cadence at
        # the reference's RECONNECT_DELAY_S; consecutive failed attempts
        # double the delay up to RECONNECT_MAX_DELAY_S. Event.wait (not
        # time.sleep) so stop() tears the loop down immediately instead
        # of leaving a sleeping daemon holding the old socket's state.
        delay = RECONNECT_DELAY_S
        while not self._closed:
            jittered = delay * random.uniform(1 - RECONNECT_JITTER,
                                              1 + RECONNECT_JITTER)
            if self._stop.wait(timeout=jittered):
                break
            if self._sock is None and not self._closed:
                try:
                    self._connect()
                    delay = RECONNECT_DELAY_S
                except OSError:
                    delay = min(delay * 2, RECONNECT_MAX_DELAY_S)
            else:
                delay = RECONNECT_DELAY_S

    def _read_loop(self) -> None:
        assembler = codec.FrameAssembler()
        sock = self._sock
        try:
            while sock is self._sock and sock is not None:
                data = sock.recv(4096)
                if not data:
                    break
                for frame in assembler.feed(data):
                    resp = codec.decode_response(frame)
                    if resp is None:
                        continue
                    with self._lock:
                        entry = self._pending.pop(resp.xid, None)
                    if entry is not None:
                        ev, slot = entry
                        slot.append(resp)
                        ev.set()
        except (OSError, ValueError):
            pass
        finally:
            if sock is self._sock:
                self._teardown()

    # ------------------------------------------------------------------
    def _roundtrip(self, req: codec.Request,
                   timeout_ms: Optional[int] = None) -> Optional[codec.Response]:
        sock = self._sock
        if sock is None:
            return None
        ev = threading.Event()
        slot: list = []
        with self._lock:
            self._pending[req.xid] = (ev, slot)
        try:
            sock.sendall(codec.encode_request(req))
        except OSError:
            with self._lock:
                self._pending.pop(req.xid, None)
            self._teardown()
            return None
        budget = (timeout_ms if timeout_ms is not None
                  else self.request_timeout_ms) / 1000.0
        if not ev.wait(timeout=budget):
            with self._lock:
                self._pending.pop(req.xid, None)
            return None
        return slot[0] if slot and slot[0] is not None else None

    # ------------------------------------------------------------------
    # TokenService surface (cluster/TokenService.java)
    # ------------------------------------------------------------------

    def ping(self) -> Optional[int]:
        resp = self._roundtrip(codec.Request(
            next(self._xids), codec.MSG_TYPE_PING, self.namespace),
            timeout_ms=2000)
        return int(resp.data) if resp is not None else None

    def request_token(self, flow_id: int, count: int = 1,
                      prioritized: bool = False) -> TokenResult:
        resp = self._roundtrip(codec.Request(
            next(self._xids), codec.MSG_TYPE_FLOW,
            (flow_id, count, prioritized)))
        if resp is None:
            return TokenResult(STATUS_FAIL)
        remaining, wait_ms = resp.data or (0, 0)
        return TokenResult(resp.status, remaining=remaining, wait_ms=wait_ms)

    def request_param_token(self, flow_id: int, count: int,
                            params: Sequence[object]) -> TokenResult:
        resp = self._roundtrip(codec.Request(
            next(self._xids), codec.MSG_TYPE_PARAM_FLOW,
            (flow_id, count, list(params))))
        if resp is None:
            return TokenResult(STATUS_FAIL)
        remaining, wait_ms = resp.data or (0, 0)
        return TokenResult(resp.status, remaining=remaining, wait_ms=wait_ms)

    # ------------------------------------------------------------------
    # Pipelined batch surface (the xid correlation already supports N
    # concurrent in-flight requests — the reference runs N caller threads
    # through one channel the same way; here one caller writes N frames
    # back-to-back and collects the responses under one shared deadline,
    # so a batch pays ~one RTT instead of N)
    # ------------------------------------------------------------------

    def _send_pipelined(self, reqs):
        """Register + write many frames in one ``sendall``; → [(xid, ev,
        slot)] or None when disconnected."""
        sock = self._sock
        if sock is None:
            return None
        entries = []
        with self._lock:
            for req in reqs:
                ev = threading.Event()
                slot: list = []
                self._pending[req.xid] = (ev, slot)
                entries.append((req.xid, ev, slot))
        try:
            sock.sendall(b"".join(codec.encode_request(r) for r in reqs))
        except OSError:
            with self._lock:
                for xid, _, _ in entries:
                    self._pending.pop(xid, None)
            self._teardown()
            return None
        return entries

    def _collect_pipelined(self, entries, timeout_ms: Optional[int]):
        """Collect responses in send order under a ROLLING deadline: every
        observed response extends the allowance by one request timeout, so
        a healthy server streaming responses never starves late items
        (preserving the reference's per-request 20 ms contract under
        pipelining), while a hung-but-connected server exhausts ONE budget
        and the remainder of the batch fails immediately — not N stacked
        timeouts."""
        budget_s = (timeout_ms if timeout_ms is not None
                    else self.request_timeout_ms) / 1000.0
        deadline = time.monotonic() + budget_s
        out = []
        for xid, ev, slot in entries:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not ev.wait(timeout=remaining):
                with self._lock:
                    self._pending.pop(xid, None)
                out.append(None)
                continue
            deadline = time.monotonic() + budget_s     # progress → extend
            out.append(slot[0] if slot and slot[0] is not None else None)
        return out

    def _batch_roundtrip(self, reqs, n: int, timeout_ms: Optional[int]):
        entries = self._send_pipelined(reqs)
        if entries is None:
            return [TokenResult(STATUS_FAIL)] * n
        out = []
        for resp in self._collect_pipelined(entries, timeout_ms):
            if resp is None:
                out.append(TokenResult(STATUS_FAIL))
            else:
                remaining, wait_ms = resp.data or (0, 0)
                out.append(TokenResult(resp.status, remaining=remaining,
                                       wait_ms=wait_ms))
        return out

    def request_tokens_batch(self, items,
                             timeout_ms: Optional[int] = None):
        """``items``: [(flow_id, count, prioritized)] → aligned
        :class:`TokenResult` list; transport failure → FAIL per item (the
        caller's fallbackToLocal semantics apply per rule)."""
        reqs = [codec.Request(next(self._xids), codec.MSG_TYPE_FLOW,
                              (int(fid), int(cnt), bool(prio)))
                for fid, cnt, prio in items]
        return self._batch_roundtrip(reqs, len(items), timeout_ms)

    def request_param_tokens_batch(self, items,
                                   timeout_ms: Optional[int] = None):
        """``items``: [(flow_id, count, params)] → aligned results."""
        reqs = [codec.Request(next(self._xids), codec.MSG_TYPE_PARAM_FLOW,
                              (int(fid), int(cnt), list(params)))
                for fid, cnt, params in items]
        return self._batch_roundtrip(reqs, len(items), timeout_ms)

    def acquire_concurrent_token(self, flow_id: int,
                                 count: int = 1) -> TokenResult:
        resp = self._roundtrip(codec.Request(
            next(self._xids), codec.MSG_TYPE_CONCURRENT_FLOW_ACQUIRE,
            (flow_id, count, False)))
        if resp is None:
            return TokenResult(STATUS_FAIL)
        return TokenResult(resp.status, token_id=int(resp.data or 0))

    def release_concurrent_token(self, token_id: int) -> TokenResult:
        resp = self._roundtrip(codec.Request(
            next(self._xids), codec.MSG_TYPE_CONCURRENT_FLOW_RELEASE,
            token_id))
        if resp is None:
            return TokenResult(STATUS_FAIL)
        return TokenResult(resp.status)
