"""gRPC interceptors (reference ``sentinel-grpc-adapter``:
``SentinelGrpcServerInterceptor.java:49`` / ``SentinelGrpcClientInterceptor.java:59``).

Resource = full gRPC method name (``/package.Service/Method``). The server
interceptor counts inbound entries (EntryType.IN) and aborts blocked calls
with RESOURCE_EXHAUSTED (the reference returns UNAVAILABLE-with-message; 429
maps to RESOURCE_EXHAUSTED in gRPC's status taxonomy). The client
interceptor guards outbound calls (EntryType.OUT) and traces non-OK
terminations into exception stats like the reference's
``ForwardingClientCallListener.onClose(status != OK)``.

The PyTorch port's own copy of ``sentinel_tpu/adapters/grpc_interceptor.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import grpc

from sentinel_tpu_torch.core.context import ContextScope
from sentinel_tpu_torch.core.errors import BlockException
from sentinel_tpu_torch.metrics.node import TYPE_RPC

GRPC_CONTEXT_NAME = "sentinel_grpc_context"
BLOCK_MSG = "Blocked by Sentinel (flow limiting)"


class SentinelServerInterceptor(grpc.ServerInterceptor):
    def __init__(self, sentinel, *,
                 origin_metadata_key: str = "sentinel-origin"):
        self.sentinel = sentinel
        self.origin_metadata_key = origin_metadata_key
        self._abort = grpc.unary_unary_rpc_method_handler(self._abort_unary)

    def _abort_unary(self, request, context):
        context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, BLOCK_MSG)

    def intercept_service(self, continuation, handler_call_details):
        resource = handler_call_details.method
        origin = ""
        for k, v in (handler_call_details.invocation_metadata or ()):
            if k == self.origin_metadata_key:
                origin = v if isinstance(v, str) else v.decode()
                break
        handler = continuation(handler_call_details)
        if handler is None:
            return None

        # wrap the behavior (not the dispatch) so entry/exit brackets the
        # actual method execution on the worker thread
        def wrap_unary(behavior):
            def guarded(request, context):
                with ContextScope(GRPC_CONTEXT_NAME, origin=origin):
                    try:
                        e = self.sentinel.entry(resource, entry_type=1,
                                                resource_type=TYPE_RPC)
                    except BlockException:
                        context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                      BLOCK_MSG)
                    try:
                        resp = behavior(request, context)
                    except BaseException as exc:
                        e.trace(exc)
                        e.exit()
                        raise
                    e.exit()
                    return resp
            return guarded

        if handler.unary_unary is not None:
            return grpc.unary_unary_rpc_method_handler(
                wrap_unary(handler.unary_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        # streaming methods: guard the stream open; per-message flow control
        # is out of scope (matches the reference, which only wraps calls)
        return handler


class SentinelClientInterceptor(grpc.UnaryUnaryClientInterceptor):
    def __init__(self, sentinel):
        self.sentinel = sentinel

    def intercept_unary_unary(self, continuation, client_call_details,
                              request):
        resource = client_call_details.method
        if isinstance(resource, bytes):
            resource = resource.decode()
        try:
            e = self.sentinel.entry(resource, entry_type=0,
                                    resource_type=TYPE_RPC)
        except BlockException as bex:
            raise _BlockedRpcError(resource) from bex
        try:
            call = continuation(client_call_details, request)
            code = call.code()
            if code is not None and code != grpc.StatusCode.OK:
                e.trace(RuntimeError(f"grpc status {code}"))
        finally:
            e.exit()
        return call


class _BlockedRpcError(grpc.RpcError):
    def __init__(self, resource: str):
        super().__init__(f"outbound call to {resource} blocked by Sentinel")

    def code(self):
        return grpc.StatusCode.RESOURCE_EXHAUSTED

    def details(self):
        return BLOCK_MSG
