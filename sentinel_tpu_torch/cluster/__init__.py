"""Cluster token transport: reference-compatible wire protocol, TCP token
server, and client SDK (SURVEY §2.3, sentinel-cluster-*) — the PyTorch
port of ``sentinel_tpu/cluster``. The server fronts a
:class:`~sentinel_tpu_torch.parallel.cluster.ClusterEngine` on the GPU;
``coordinator`` switches an app between client and embedded server, and
``commands`` holds the ``cluster/server/*`` command handlers;
``grpc_token`` serves the engine over a batched gRPC API and
``envoy_rls`` as an Envoy Rate Limit Service (both import ``grpc`` and
``google.protobuf`` only when a server or client is built)."""

from sentinel_tpu_torch.cluster.codec import (  # noqa: F401
    MSG_TYPE_PING, MSG_TYPE_FLOW, MSG_TYPE_PARAM_FLOW,
    MSG_TYPE_CONCURRENT_FLOW_ACQUIRE, MSG_TYPE_CONCURRENT_FLOW_RELEASE,
    DEFAULT_CLUSTER_SERVER_PORT, DEFAULT_REQUEST_TIMEOUT_MS,
    FrameAssembler, Request, Response,
    decode_request, decode_response, encode_request, encode_response,
)
from sentinel_tpu_torch.cluster.server import ClusterTokenServer  # noqa: F401
from sentinel_tpu_torch.cluster.client import ClusterTokenClient, TokenResult  # noqa: F401
