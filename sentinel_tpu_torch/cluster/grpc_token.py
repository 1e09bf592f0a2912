"""Batched gRPC token-service frontend: the port of
``sentinel_tpu/cluster/grpc_token.py`` (same service name, messages and
semantics).

The reference serves tokens over two surfaces: the Netty frame protocol
(``TokenServerHandler.java`` — mirrored byte-compatibly by
:mod:`sentinel_tpu_torch.cluster.server`) and a gRPC server for Envoy RLS
(``SentinelRlsGrpcServer.java`` — mirrored by
:mod:`sentinel_tpu_torch.cluster.envoy_rls`). This module is the sibling:
a clean batched gRPC API over the same sharded
:class:`~sentinel_tpu_torch.parallel.cluster.ClusterEngine` (on the GPU
unless it was built on the CPU), so a remote serving
process can fetch a whole batch of verdicts in one RPC the way the
in-process embedded facade does (``DefaultTokenService.requestToken`` /
``requestParamToken`` lifted to batches).

Server::

    srv = TokenGrpcServer(engine, port=0, clock=clock)
    port = srv.start()

Client (the whole integration)::

    cli = GrpcTokenClient(f"127.0.0.1:{port}", timeout_ms=20)
    results = cli.request_tokens_batch([(fid, 1, False), ...])

Deadline → fallback: the client stamps every RPC with its timeout (the
reference budget — ``ClusterConstants.DEFAULT_REQUEST_TIMEOUT`` = 20 ms) and
maps DeadlineExceeded/transport errors to ``STATUS_FAIL`` per item, which is
exactly what the runtime's per-rule ``fallbackToLocalWhenFail`` consumes —
so ``GrpcTokenClient`` plugs straight into ``Sentinel.set_token_service``.

``grpc`` and ``google.protobuf`` are imported only when a server or a
client is built; the service core needs neither.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from sentinel_tpu_torch.core.clock import Clock
from sentinel_tpu_torch.parallel.cluster import (
    STATUS_BAD_REQUEST, STATUS_FAIL, ClusterEngine,
)

SERVICE_NAME = "sentinel.cluster.v1.TokenService"
DEFAULT_PORT = 11000
# reference ClusterConstants.DEFAULT_REQUEST_TIMEOUT (ms)
DEFAULT_TIMEOUT_MS = 20
# hard cap on per-RPC batch size: a huge batch would stall every other
# caller behind one device step (and a malicious one would OOM the host)
MAX_BATCH = 65536


class TokenGrpcService:
    """Protocol-neutral core (testable without gRPC): a mixed batch splits
    into flow and hot-param sub-batches — each one engine step — and the
    results re-align to request order."""

    def __init__(self, engine: ClusterEngine, clock: Optional[Clock] = None):
        self.engine = engine
        self._clock = clock or Clock()

    def request_tokens(self, items: Sequence[Tuple[int, int, bool,
                                                   Sequence[str]]]
                       ) -> List[Tuple[int, int, int]]:
        """``items``: (flow_id, acquire, prioritized, params) rows →
        aligned (status, wait_ms, remaining) rows."""
        if len(items) > MAX_BATCH:
            return [(STATUS_BAD_REQUEST, 0, 0)] * len(items)
        now = self._clock.now_ms()
        out: List[Optional[Tuple[int, int, int]]] = [None] * len(items)
        flow_idx: List[int] = []
        flow_req: List[Tuple[int, int, bool]] = []
        param_idx: List[int] = []
        param_req: List[Tuple[int, int, List[str]]] = []
        for i, (fid, acquire, prioritized, params) in enumerate(items):
            if acquire <= 0:
                out[i] = (STATUS_BAD_REQUEST, 0, 0)
            elif params:
                param_idx.append(i)
                param_req.append((int(fid), int(acquire), list(params)))
            else:
                flow_idx.append(i)
                flow_req.append((int(fid), int(acquire), bool(prioritized)))
        if flow_req:
            res = self.engine.request_tokens(
                [r[0] for r in flow_req], [r[1] for r in flow_req],
                [r[2] for r in flow_req], now_ms=now)
            for i, r in zip(flow_idx, res):
                out[i] = (int(r[0]), int(r[1]), int(r[2]))
        if param_req:
            res = self.engine.request_param_tokens(
                [r[0] for r in param_req], [r[1] for r in param_req],
                [r[2] for r in param_req], now_ms=now)
            for i, r in zip(param_idx, res):
                out[i] = (int(r[0]), int(r[1]), int(r[2]))
        # A misbehaving engine returning fewer rows than requested must
        # degrade to per-item FAIL (like a transport error), not crash the
        # proto response construction with an opaque RPC error.
        return [(STATUS_FAIL, 0, 0) if r is None else r for r in out]


class TokenGrpcServer:
    """gRPC frontend over :class:`TokenGrpcService` — hand-wired generic
    handler like the RLS server (no grpc codegen plugin needed)."""

    def __init__(self, engine: ClusterEngine, host: str = "0.0.0.0",
                 port: int = DEFAULT_PORT, max_workers: int = 8,
                 clock: Optional[Clock] = None):
        self.service = TokenGrpcService(engine, clock=clock)
        self.host = host
        self.requested_port = port
        self.port: Optional[int] = None
        self._server = None
        self._max_workers = max_workers

    def _handler(self):
        import grpc

        from sentinel_tpu_torch.cluster.proto import token_service_pb2 as pb

        def request_tokens(request, context):
            # acquire passes through raw: 0/negative → STATUS_BAD_REQUEST in
            # the service, matching the engine and Netty surfaces (a proto3
            # default-0 means the client didn't set a count — that's a bad
            # request, not a grant of 1)
            items = [(r.flow_id, r.acquire, r.prioritized,
                      list(r.params)) for r in request.requests]
            resp = pb.BatchTokenResponse()
            for status, wait_ms, remaining in self.service.request_tokens(
                    items):
                resp.responses.add(status=status, wait_ms=wait_ms,
                                   remaining=remaining)
            return resp

        return grpc.method_handlers_generic_handler(
            SERVICE_NAME,
            {"RequestTokens": grpc.unary_unary_rpc_method_handler(
                request_tokens,
                request_deserializer=pb.BatchTokenRequest.FromString,
                response_serializer=pb.BatchTokenResponse.SerializeToString)})

    def start(self) -> int:
        import grpc
        from concurrent import futures
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self._max_workers))
        self._server.add_generic_rpc_handlers((self._handler(),))
        self.port = self._server.add_insecure_port(
            f"{self.host}:{self.requested_port}")
        if self.port == 0:
            raise OSError(
                f"cannot bind token-service port {self.requested_port}")
        self._server.start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=None)
            self._server = None


class _GrpcResult:
    """TokenResult-shaped row (duck-typed like the other token services)."""

    __slots__ = ("status", "wait_ms", "remaining")

    def __init__(self, status: int, wait_ms: int = 0, remaining: int = 0):
        self.status = status
        self.wait_ms = wait_ms
        self.remaining = remaining


class GrpcTokenClient:
    """Client speaking the batched API; satisfies the runtime's token-service
    duck type (``request_token`` + ``request_tokens_batch`` +
    ``request_param_token``), so it installs via
    ``Sentinel.set_token_service`` exactly like the Netty client. Every RPC
    carries the deadline; DeadlineExceeded and transport errors map to
    ``STATUS_FAIL`` per item — the caller's per-rule
    ``fallbackToLocalWhenFail`` then checks locally, never fails open."""

    def __init__(self, target: str, namespace: str = "default",
                 timeout_ms: int = DEFAULT_TIMEOUT_MS):
        import grpc

        from sentinel_tpu_torch.cluster.proto import token_service_pb2 as pb
        self._pb = pb
        self.namespace = namespace
        self.timeout_ms = timeout_ms
        self._channel = grpc.insecure_channel(target)
        self._call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/RequestTokens",
            request_serializer=pb.BatchTokenRequest.SerializeToString,
            response_deserializer=pb.BatchTokenResponse.FromString)

    def close(self) -> None:
        self._channel.close()

    # ---------------------------------------------------------- batched
    def request_tokens_batch(self, items) -> List[_GrpcResult]:
        """``items``: [(flow_id, count, prioritized)] → aligned results."""
        return self._batch([(fid, cnt, prio, ()) for fid, cnt, prio in items])

    def request_param_tokens_batch(self, items) -> List[_GrpcResult]:
        """``items``: [(flow_id, count, params)] → aligned results."""
        return self._batch([(fid, cnt, False,
                             [str(p) for p in params])
                            for fid, cnt, params in items])

    def _batch(self, rows) -> List[_GrpcResult]:
        pb = self._pb
        req = pb.BatchTokenRequest(namespace=self.namespace)
        for fid, cnt, prio, params in rows:
            req.requests.add(flow_id=int(fid), acquire=int(cnt),
                             prioritized=bool(prio), params=params)
        try:
            resp = self._call(req, timeout=self.timeout_ms / 1000.0)
        except Exception:
            # deadline exceeded / unavailable / transport reset → FAIL per
            # item (fallbackToLocal applies; never fail open)
            return [_GrpcResult(STATUS_FAIL)] * len(rows)
        if len(resp.responses) != len(rows):
            return [_GrpcResult(STATUS_FAIL)] * len(rows)
        return [_GrpcResult(r.status, r.wait_ms, r.remaining)
                for r in resp.responses]

    # ------------------------------------------------------- single-call
    def request_token(self, flow_id: int, count: int = 1,
                      prioritized: bool = False) -> _GrpcResult:
        return self.request_tokens_batch([(flow_id, count, prioritized)])[0]

    def request_param_token(self, flow_id: int, count: int,
                            params) -> _GrpcResult:
        return self.request_param_tokens_batch(
            [(flow_id, count, list(params))])[0]
