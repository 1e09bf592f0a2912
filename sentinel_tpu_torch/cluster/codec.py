"""Cluster wire protocol codec — byte-compatible with the reference.

Frame layout (``sentinel-cluster-common-default``; server pipeline
``NettyTransportServer``: ``LengthFieldBasedFrameDecoder(1024, 0, 2, 0, 2)`` +
2-byte ``LengthFieldPrepender``):

    [len:2 BE (body only)] [body]

Request body (``DefaultRequestEntityDecoder.java``):

    [xid:4 BE] [type:1] [data]

Response body (``DefaultResponseEntityWriter.writeHead``):

    [xid:4 BE] [type:1] [status:1 signed] [data]

Data payloads:

* PING (type 0): request = ``[nsLen:4 BE][namespace utf-8]``
  (``PingRequestDataDecoder.java``); response = ``[curCount:4 BE]``
  (``PingResponseDataWriter.java``).
* FLOW (type 1): request = ``[flowId:8 BE][count:4 BE][priority:1]``
  (``FlowRequestDataDecoder.java``); response =
  ``[remaining:4 BE][waitInMs:4 BE]`` (``FlowResponseDataWriter.java``).
* PARAM_FLOW (type 2): request = ``[flowId:8][count:4][amount:4][TLV × amount]``
  with TLV tags int=0/long=1/byte=2/double=3/float=4/short=5/bool=6/string=7
  (string = ``[7][len:4][utf-8]``) — ``ParamFlowRequestDataDecoder.java``,
  ``ClusterConstants.java:34-41``; response same as FLOW.
* CONCURRENT_FLOW_ACQUIRE (type 3) / _RELEASE (type 4): the reference defines
  the message type ids (``ClusterConstants.java:27-28``) but ships no client
  codec for them in 1.8.6 — this framework completes the pair as a documented
  extension: acquire request = ``[flowId:8][count:4][prioritized:1]``,
  acquire response = ``[tokenId:8]``; release request = ``[tokenId:8]``,
  release response = empty.

The response ``status`` byte carries ``TokenResultStatus`` codes
(``sentinel_tpu_torch.parallel.cluster.STATUS_*``), signed.

The PyTorch port's own copy of ``sentinel_tpu/cluster/codec.py``: the
bytes on the wire are the reference's, so either package's server talks
to either package's client (and to Java Sentinel clients).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

MSG_TYPE_PING = 0
MSG_TYPE_FLOW = 1
MSG_TYPE_PARAM_FLOW = 2
MSG_TYPE_CONCURRENT_FLOW_ACQUIRE = 3
MSG_TYPE_CONCURRENT_FLOW_RELEASE = 4

RESPONSE_STATUS_BAD = -1
RESPONSE_STATUS_OK = 0

DEFAULT_CLUSTER_SERVER_PORT = 18730
DEFAULT_REQUEST_TIMEOUT_MS = 20
MAX_FRAME_BYTES = 1024

PARAM_TYPE_INTEGER = 0
PARAM_TYPE_LONG = 1
PARAM_TYPE_BYTE = 2
PARAM_TYPE_DOUBLE = 3
PARAM_TYPE_FLOAT = 4
PARAM_TYPE_SHORT = 5
PARAM_TYPE_BOOLEAN = 6
PARAM_TYPE_STRING = 7


@dataclasses.dataclass
class Request:
    xid: int
    type: int
    # decoded payload per type: PING → namespace str; FLOW → (flow_id, count,
    # prioritized); PARAM_FLOW → (flow_id, count, params list);
    # CONCURRENT acquire → (flow_id, count, prioritized); release → token_id
    data: object


@dataclasses.dataclass
class Response:
    xid: int
    type: int
    status: int
    # payload per type: PING → int; FLOW/PARAM_FLOW → (remaining, wait_ms);
    # CONCURRENT acquire → token_id; release → None
    data: object = None


# ----------------------------------------------------------------------
# TLV params
# ----------------------------------------------------------------------

def _encode_param(out: bytearray, value: object) -> None:
    if isinstance(value, bool):           # before int: bool is an int subtype
        out.append(PARAM_TYPE_BOOLEAN)
        out.append(1 if value else 0)
    elif isinstance(value, int):
        if -2 ** 31 <= value < 2 ** 31:
            out.append(PARAM_TYPE_INTEGER)
            out += struct.pack(">i", value)
        else:
            out.append(PARAM_TYPE_LONG)
            out += struct.pack(">q", value)
    elif isinstance(value, float):
        out.append(PARAM_TYPE_DOUBLE)
        out += struct.pack(">d", value)
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out.append(PARAM_TYPE_STRING)
        out += struct.pack(">i", len(raw))
        out += raw
    else:
        raise TypeError(f"unsupported param type: {type(value).__name__}")


def _decode_param(buf: memoryview, off: int) -> Tuple[object, int]:
    tag = buf[off]
    off += 1
    if tag == PARAM_TYPE_INTEGER:
        return struct.unpack_from(">i", buf, off)[0], off + 4
    if tag == PARAM_TYPE_LONG:
        return struct.unpack_from(">q", buf, off)[0], off + 8
    if tag == PARAM_TYPE_BYTE:
        return struct.unpack_from(">b", buf, off)[0], off + 1
    if tag == PARAM_TYPE_DOUBLE:
        return struct.unpack_from(">d", buf, off)[0], off + 8
    if tag == PARAM_TYPE_FLOAT:
        return struct.unpack_from(">f", buf, off)[0], off + 4
    if tag == PARAM_TYPE_SHORT:
        return struct.unpack_from(">h", buf, off)[0], off + 2
    if tag == PARAM_TYPE_BOOLEAN:
        return buf[off] != 0, off + 1
    if tag == PARAM_TYPE_STRING:
        n = struct.unpack_from(">i", buf, off)[0]
        off += 4
        return bytes(buf[off:off + n]).decode("utf-8"), off + n
    raise ValueError(f"unknown param TLV tag {tag}")


# ----------------------------------------------------------------------
# Request / response bodies
# ----------------------------------------------------------------------

def encode_request(req: Request) -> bytes:
    body = bytearray(struct.pack(">ib", req.xid, req.type))
    t = req.type
    if t == MSG_TYPE_PING:
        raw = str(req.data or "").encode("utf-8")
        body += struct.pack(">i", len(raw))
        body += raw
    elif t in (MSG_TYPE_FLOW, MSG_TYPE_CONCURRENT_FLOW_ACQUIRE):
        flow_id, count, prioritized = req.data
        body += struct.pack(">qib", flow_id, count, 1 if prioritized else 0)
    elif t == MSG_TYPE_PARAM_FLOW:
        flow_id, count, params = req.data
        body += struct.pack(">qii", flow_id, count, len(params))
        for v in params:
            _encode_param(body, v)
    elif t == MSG_TYPE_CONCURRENT_FLOW_RELEASE:
        body += struct.pack(">q", req.data)
    else:
        raise ValueError(f"unknown request type {t}")
    if len(body) > MAX_FRAME_BYTES:
        raise ValueError(f"frame too large: {len(body)}")
    return struct.pack(">H", len(body)) + bytes(body)


def decode_request(body: bytes) -> Optional[Request]:
    if len(body) < 5:
        return None
    xid, t = struct.unpack_from(">ib", body, 0)
    mv = memoryview(body)
    off = 5
    if t == MSG_TYPE_PING:
        if len(body) < off + 4:
            return Request(xid, t, "")
        n = struct.unpack_from(">i", mv, off)[0]
        ns = bytes(mv[off + 4:off + 4 + n]).decode("utf-8") if n > 0 else ""
        return Request(xid, t, ns)
    if t in (MSG_TYPE_FLOW, MSG_TYPE_CONCURRENT_FLOW_ACQUIRE):
        if len(body) < off + 12:
            return None
        flow_id, count = struct.unpack_from(">qi", mv, off)
        prio = body[off + 12] != 0 if len(body) > off + 12 else False
        return Request(xid, t, (flow_id, count, prio))
    if t == MSG_TYPE_PARAM_FLOW:
        if len(body) < off + 16:
            return None
        flow_id, count, amount = struct.unpack_from(">qii", mv, off)
        off += 16
        params: List[object] = []
        for _ in range(max(0, amount)):
            v, off = _decode_param(mv, off)
            params.append(v)
        return Request(xid, t, (flow_id, count, params))
    if t == MSG_TYPE_CONCURRENT_FLOW_RELEASE:
        if len(body) < off + 8:
            return None
        return Request(xid, t, struct.unpack_from(">q", mv, off)[0])
    return Request(xid, t, None)  # unknown type → server answers BAD


def encode_response(resp: Response) -> bytes:
    body = bytearray(struct.pack(">ibb", resp.xid, resp.type, resp.status))
    t = resp.type
    if t == MSG_TYPE_PING:
        body += struct.pack(">i", int(resp.data or 0))
    elif t in (MSG_TYPE_FLOW, MSG_TYPE_PARAM_FLOW):
        remaining, wait_ms = resp.data if resp.data is not None else (0, 0)
        body += struct.pack(">ii", remaining, wait_ms)
    elif t == MSG_TYPE_CONCURRENT_FLOW_ACQUIRE:
        body += struct.pack(">q", int(resp.data or 0))
    # RELEASE and unknown types: head only
    return struct.pack(">H", len(body)) + bytes(body)


def decode_response(body: bytes) -> Optional[Response]:
    if len(body) < 6:
        return None
    xid, t, status = struct.unpack_from(">ibb", body, 0)
    off = 6
    if t == MSG_TYPE_PING and len(body) >= off + 4:
        return Response(xid, t, status, struct.unpack_from(">i", body, off)[0])
    if t in (MSG_TYPE_FLOW, MSG_TYPE_PARAM_FLOW) and len(body) >= off + 8:
        return Response(xid, t, status,
                        tuple(struct.unpack_from(">ii", body, off)))
    if t == MSG_TYPE_CONCURRENT_FLOW_ACQUIRE and len(body) >= off + 8:
        return Response(xid, t, status, struct.unpack_from(">q", body, off)[0])
    return Response(xid, t, status, None)


class FrameAssembler:
    """Stream reassembly of 2-byte length-prefixed frames
    (LengthFieldBasedFrameDecoder semantics; max body 1024)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf += data
        frames: List[bytes] = []
        while True:
            if len(self._buf) < 2:
                return frames
            n = struct.unpack_from(">H", self._buf, 0)[0]
            if n > MAX_FRAME_BYTES:
                raise ValueError(f"frame length {n} exceeds {MAX_FRAME_BYTES}")
            if len(self._buf) < 2 + n:
                return frames
            frames.append(bytes(self._buf[2:2 + n]))
            del self._buf[:2 + n]
