# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: serve.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bserve.proto\x12\rray_tpu.serve\"\\\n\x0cServeRequest\x12\r\n\x05route\x18\x01 \x01(\t\x12\x0e\n\x06method\x18\x02 \x01(\t\x12\x1c\n\x14multiplexed_model_id\x18\x03 \x01(\t\x12\x0f\n\x07payload\x18\x04 \x01(\x0c\"\x1d\n\nServeReply\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\",\n\nServeChunk\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\x12\r\n\x05\x66inal\x18\x02 \x01(\x08\x32\x95\x01\n\x0bRayServeAPI\x12>\n\x04\x43\x61ll\x12\x1b.ray_tpu.serve.ServeRequest\x1a\x19.ray_tpu.serve.ServeReply\x12\x46\n\nCallStream\x12\x1b.ray_tpu.serve.ServeRequest\x1a\x19.ray_tpu.serve.ServeChunk0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'serve_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SERVEREQUEST._serialized_start=30
  _SERVEREQUEST._serialized_end=122
  _SERVEREPLY._serialized_start=124
  _SERVEREPLY._serialized_end=153
  _SERVECHUNK._serialized_start=155
  _SERVECHUNK._serialized_end=199
  _RAYSERVEAPI._serialized_start=202
  _RAYSERVEAPI._serialized_end=351
# @@protoc_insertion_point(module_scope)
