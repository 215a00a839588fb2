"""Wire protocol: framed, versioned messages for cross-process control RPC.

Reference analogue: `src/ray/protobuf/*.proto` + the gRPC plumbing in
`src/ray/rpc/` — the reference serializes every control-plane surface so
daemons on different hosts interoperate. TPU-native scope: the DATA plane
here is XLA collectives over ICI (jax.distributed), which needs no runtime
wire format; what must serialize is the CONTROL plane (node/actor/job/KV
tables, object locations). This module is that wire format.

Frame layout (all integers big-endian):

    [4B length] [1B version] [1B msg type] [length-6 bytes payload]

Payload is pickle protocol 5 of a plain dict (schema per message type
below). Pickle-over-TCP is acceptable here for the same reason the
reference trusts protobuf-over-gRPC: the control plane is an internal,
mutually-trusted surface, never exposed to user traffic.

Message types:
    REQUEST  {"id": int, "method": str, "args": tuple, "kwargs": dict}
    RESPONSE {"id": int, "ok": bool, "value": Any} |
             {"id": int, "ok": False, "error": str, "exc": Exception}
    EVENT    {"channel": str, "message": Any}   (server -> client push)
    BLOB     [8B req id][8B offset][raw bytes]  (zero-copy chunk lane:
             the payload is NOT pickled — the sender scatter-gathers a
             header plus a memoryview, the receiver recv_intos straight
             into a caller-provided buffer at the carried offset)

The port's copy of ray_tpu/core/wire.py; in the port it frames the object
transfer plane (core/object_transfer.py), the control-plane RPC
(core/rpc.py) and the cross-host dispatch plane (core/cross_host.py).
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Any, Callable, Optional, Tuple

WIRE_VERSION = 1

MSG_REQUEST = 1
MSG_RESPONSE = 2
MSG_EVENT = 3
MSG_BLOB = 4

_HEADER = struct.Struct(">IBB")  # length, version, type
_BLOB_PREFIX = struct.Struct(">QQ")  # request id, byte offset
_MAX_FRAME = 256 << 20  # 256 MB control message ceiling


class WireError(ConnectionError):
    pass


# Chaos fault-injection hook (ray_tpu.util.chaos): when set, consulted
# before every frame send/recv in THIS process. Raising OSError simulates
# a partition at the RPC socket layer; sleeping simulates link delay.
_fault_injector: Optional[Callable[[socket.socket, str], None]] = None


def set_fault_injector(fn: Optional[Callable[[socket.socket, str], None]]) -> None:
    """Install (or clear, with None) the process-wide wire fault hook."""
    global _fault_injector
    _fault_injector = fn


def send_msg(sock: socket.socket, msg_type: int, payload: Any) -> None:
    inj = _fault_injector
    if inj is not None:
        inj(sock, "send")
    body = pickle.dumps(payload, protocol=5)
    if len(body) + 2 > _MAX_FRAME:
        raise WireError(f"frame too large: {len(body)} bytes")
    sock.sendall(_HEADER.pack(len(body) + 2, WIRE_VERSION, msg_type) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise WireError("connection closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> Tuple[int, Any]:
    """-> (msg_type, payload). Raises WireError on close/corruption."""
    inj = _fault_injector
    if inj is not None:
        inj(sock, "recv")
    header = _recv_exact(sock, _HEADER.size)
    length, version, msg_type = _HEADER.unpack(header)
    if version != WIRE_VERSION:
        raise WireError(f"wire version {version} != {WIRE_VERSION}")
    if length < 2 or length > _MAX_FRAME:
        raise WireError(f"bad frame length {length}")
    body = _recv_exact(sock, length - 2)
    return msg_type, pickle.loads(body)


def send_blob(sock: socket.socket, req_id: int, offset: int,
              view: "memoryview | bytes | bytearray") -> None:
    """Send a MSG_BLOB frame without copying or pickling the payload.

    The kernel gathers the 22-byte header and the data view in one
    sendmsg; on a short write the remainder is completed with sendall
    over sub-views, still copy-free on the Python side.
    """
    inj = _fault_injector
    if inj is not None:
        inj(sock, "send")
    data = memoryview(view)
    if data.ndim != 1 or data.format != "B":
        data = data.cast("B")
    n = len(data)
    if n + 2 + _BLOB_PREFIX.size > _MAX_FRAME:
        raise WireError(f"blob frame too large: {n} bytes")
    hdr = _HEADER.pack(n + 2 + _BLOB_PREFIX.size, WIRE_VERSION, MSG_BLOB)
    prefix = _BLOB_PREFIX.pack(req_id, offset)
    sent = sock.sendmsg([hdr, prefix, data])
    skip = len(hdr) + len(prefix)
    if sent < skip:
        sock.sendall((hdr + prefix)[sent:])
        sent = skip
    if sent - skip < n:
        sock.sendall(data[sent - skip:])


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    while view.nbytes:
        k = sock.recv_into(view, view.nbytes)
        if not k:
            raise WireError("connection closed mid-blob")
        view = view[k:]


def recv_frame_into(
    sock: socket.socket,
    sink_for: Callable[[int, int, int], memoryview],
) -> Tuple[int, Any]:
    """recv_msg variant that lands MSG_BLOB payloads in caller memory.

    Non-blob frames behave exactly like recv_msg. For a blob frame the
    caller's `sink_for(req_id, offset, nbytes)` must return a writable
    memoryview of exactly `nbytes`; the payload is recv_into'd there and
    the return value is (MSG_BLOB, (req_id, offset, nbytes)).
    """
    inj = _fault_injector
    if inj is not None:
        inj(sock, "recv")
    header = _recv_exact(sock, _HEADER.size)
    length, version, msg_type = _HEADER.unpack(header)
    if version != WIRE_VERSION:
        raise WireError(f"wire version {version} != {WIRE_VERSION}")
    if length < 2 or length > _MAX_FRAME:
        raise WireError(f"bad frame length {length}")
    if msg_type != MSG_BLOB:
        body = _recv_exact(sock, length - 2)
        return msg_type, pickle.loads(body)
    if length < 2 + _BLOB_PREFIX.size:
        raise WireError(f"short blob frame: {length}")
    req_id, offset = _BLOB_PREFIX.unpack(_recv_exact(sock, _BLOB_PREFIX.size))
    nbytes = length - 2 - _BLOB_PREFIX.size
    sink = sink_for(req_id, offset, nbytes)
    if sink.nbytes != nbytes:
        raise WireError(f"blob sink mismatch: {sink.nbytes} != {nbytes}")
    _recv_exact_into(sock, sink)
    return MSG_BLOB, (req_id, offset, nbytes)
