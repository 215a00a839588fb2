"""Generated protobuf messages for the typed serve gRPC ingress.

serve_pb2.py is generated from serve.proto by `protoc --python_out=.`;
this copy is byte-identical to ray_tpu/serve/protos/serve_pb2.py, so both
packages register the same `serve.proto` in protobuf's default pool and
share its message classes. Service method strings are addressed through
grpc's generic handler/channel API, which needs only these message
classes on both sides. Importing this package imports protobuf.
"""

from .serve_pb2 import ServeChunk, ServeReply, ServeRequest  # noqa: F401
