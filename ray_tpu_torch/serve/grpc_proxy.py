"""gRPC ingress for serve (reference: `serve/_private/proxy.py`'s gRPC
server path + `serve/grpc_util.py` + `serve/generated/serve_pb2`).

The port's copy of ray_tpu/serve/grpc_proxy.py. `grpc` and the protobuf
messages are imported only inside the functions that serve a call, so
`import ray_tpu_torch.serve` needs neither.

Two contracts on one server:

1. TYPED (reference parity): the `ray_tpu.serve.RayServeAPI` proto
   service (`serve/protos/serve.proto`) — `Call` (unary) and
   `CallStream` (SERVER STREAMING: a deployment returning a generator
   streams one ServeChunk per item, terminal chunk has final=true).
   Routing/method/multiplexed_model_id are typed fields; the app payload
   rides as JSON bytes so arbitrary app schemas need no per-app codegen.

       from ray_tpu_torch.serve.protos import ServeRequest, ServeReply, ServeChunk
       ch = grpc.insecure_channel(f"127.0.0.1:{port}")
       call = ch.unary_unary("/ray_tpu.serve.RayServeAPI/Call",
                             request_serializer=ServeRequest.SerializeToString,
                             response_deserializer=ServeReply.FromString)
       out = json.loads(call(ServeRequest(route="myapp",
                                          payload=b'{"x": 1}')).payload)

2. GENERIC (proto-less, v1 back-compat): the method path IS the route —
   ``/<app_route>/<method>`` with JSON bytes both ways. Appending
   ``:stream`` to the path upgrades it to server streaming
   (``/<app_route>/<method>:stream`` yields JSON chunks).
"""

from __future__ import annotations

import json
from typing import Any

from ..core.logging import get_logger

logger = get_logger("serve.grpc")


def _identity(b: bytes) -> bytes:
    return b


class GrpcProxy:
    """Generic-handler gRPC server routing to deployment handles.

    Routes resolve through the SAME registry the HTTP proxy uses (the
    callable passed in returns {route: handle}), so apps deployed or
    deleted after startup are picked up without re-registration."""

    def __init__(self, routes_fn, host: str = "127.0.0.1", port: int = 0):
        self._routes_fn = routes_fn
        self.host = host
        self.port = port
        self._server = None

    TYPED_SERVICE = "ray_tpu.serve.RayServeAPI"

    def start(self) -> int:
        from concurrent.futures import ThreadPoolExecutor

        import grpc

        from .protos import ServeChunk, ServeReply, ServeRequest

        proxy = self

        class Generic(grpc.GenericRpcHandler):
            def service(self, details):
                parts = [p for p in details.method.split("/") if p]
                if parts and parts[0] == proxy.TYPED_SERVICE:
                    rpc = parts[1] if len(parts) > 1 else ""
                    if rpc == "Call":
                        return grpc.unary_unary_rpc_method_handler(
                            proxy._typed_call,
                            request_deserializer=ServeRequest.FromString,
                            response_serializer=ServeReply.SerializeToString,
                        )
                    if rpc == "CallStream":
                        return grpc.unary_stream_rpc_method_handler(
                            proxy._typed_call_stream,
                            request_deserializer=ServeRequest.FromString,
                            response_serializer=ServeChunk.SerializeToString,
                        )
                    return None
                if parts and parts[-1].endswith(":stream"):
                    parts = parts[:-1] + [parts[-1][: -len(":stream")]]

                    def handle_stream(request: bytes, context):
                        yield from proxy._dispatch_stream(
                            parts, request, context,
                            lambda b: b,
                        )

                    return grpc.unary_stream_rpc_method_handler(
                        handle_stream,
                        request_deserializer=_identity,
                        response_serializer=_identity,
                    )

                def handle_unary(request: bytes, context):
                    return proxy._dispatch(parts, request, context)

                return grpc.unary_unary_rpc_method_handler(
                    handle_unary,
                    request_deserializer=_identity,
                    response_serializer=_identity,
                )

        self._server = grpc.server(
            thread_pool=ThreadPoolExecutor(max_workers=16),
        )
        self._server.add_generic_rpc_handlers((Generic(),))
        self.port = self._server.add_insecure_port(f"{self.host}:{self.port}")
        self._server.start()
        logger.info("gRPC proxy on %s:%d (typed service %s + generic JSON)",
                    self.host, self.port, self.TYPED_SERVICE)
        return self.port

    # -- typed service ------------------------------------------------------
    def _typed_parts(self, req):
        parts = [req.route or "default"]
        if req.method:
            parts.append(req.method)
        return parts

    def _resolve_typed(self, req, context):
        import grpc

        from .http_proxy import resolve_route

        handle, rest = resolve_route(self._typed_parts(req), self._routes_fn())
        if handle is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no app at route {req.route!r}")
        if rest and rest != ["__call__"]:
            handle = handle.options("_".join(rest))
        if req.multiplexed_model_id:
            handle = handle.options(
                multiplexed_model_id=req.multiplexed_model_id)
        try:
            payload = json.loads(req.payload) if req.payload else {}
        except json.JSONDecodeError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad json: {e}")
        return handle, payload

    def _typed_call(self, req, context):
        import grpc

        from .protos import ServeReply

        handle, payload = self._resolve_typed(req, context)
        try:
            result = handle.remote(payload).result(timeout=300.0)
            if hasattr(result, "__next__"):
                result = list(result)  # use CallStream for true streaming
            return ServeReply(
                payload=json.dumps(_jsonable(result)).encode())
        except Exception as e:  # noqa: BLE001 — surfaced as gRPC status
            logger.warning("grpc typed call failed", exc_info=True)
            context.abort(grpc.StatusCode.INTERNAL, repr(e))

    def _typed_call_stream(self, req, context):
        import grpc

        from .protos import ServeChunk

        handle, payload = self._resolve_typed(req, context)
        try:
            result = handle.remote(payload).result(timeout=300.0)
            chunks = result if hasattr(result, "__next__") else iter([result])
            for chunk in chunks:
                yield ServeChunk(
                    payload=json.dumps(_jsonable(chunk)).encode())
            yield ServeChunk(payload=b"", final=True)
        except Exception as e:  # noqa: BLE001 — surfaced as gRPC status
            logger.warning("grpc stream failed", exc_info=True)
            context.abort(grpc.StatusCode.INTERNAL, repr(e))

    # -- generic (proto-less) ----------------------------------------------
    def _dispatch_stream(self, parts, request: bytes, context, enc):
        """Generic server streaming: JSON chunk per item, then [DONE]."""
        import grpc

        from .http_proxy import resolve_route

        handle, rest = resolve_route(parts, self._routes_fn())
        if handle is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no app at /{'/'.join(parts)}")
        if rest and rest != ["__call__"]:
            handle = handle.options("_".join(rest))
        try:
            payload = json.loads(request) if request else {}
        except json.JSONDecodeError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad json: {e}")
        try:
            result = handle.remote(payload).result(timeout=300.0)
            chunks = result if hasattr(result, "__next__") else iter([result])
            for chunk in chunks:
                yield enc(json.dumps(_jsonable(chunk)).encode())
            yield enc(b"[DONE]")
        except Exception as e:  # noqa: BLE001 — surfaced as gRPC status
            logger.warning("grpc stream failed", exc_info=True)
            context.abort(grpc.StatusCode.INTERNAL, repr(e))

    def _dispatch(self, parts, request: bytes, context) -> bytes:
        import grpc

        from .http_proxy import resolve_route

        handle, rest = resolve_route(parts, self._routes_fn())
        if handle is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no app at /{'/'.join(parts)}")
        if rest and rest != ["__call__"]:
            handle = handle.options("_".join(rest))
        try:
            payload = json.loads(request) if request else {}
        except json.JSONDecodeError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad json: {e}")
        try:
            result = handle.remote(payload).result(timeout=300.0)
            if hasattr(result, "__next__"):
                result = list(result)  # stream collected for the unary reply
            return json.dumps(_jsonable(result)).encode()
        except Exception as e:  # noqa: BLE001 — surfaced as gRPC status
            logger.warning("grpc request failed", exc_info=True)
            context.abort(grpc.StatusCode.INTERNAL, repr(e))

    def stop(self) -> None:
        if self._server is not None:
            # stop() is non-blocking: wait out the drain so the port is
            # actually free and no request resolves against cleared routes
            self._server.stop(grace=1.0).wait()
            self._server = None


def _jsonable(x: Any) -> Any:
    from .http_proxy import _jsonable as impl

    return impl(x)
