# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: envoy_rls.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0f\x65nvoy_rls.proto\x12\x1a\x65nvoy.service.ratelimit.v3\"\x82\x01\n\x13RateLimitDescriptor\x12\x46\n\x07\x65ntries\x18\x01 \x03(\x0b\x32\x35.envoy.service.ratelimit.v3.RateLimitDescriptor.Entry\x1a#\n\x05\x45ntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"}\n\x10RateLimitRequest\x12\x0e\n\x06\x64omain\x18\x01 \x01(\t\x12\x44\n\x0b\x64\x65scriptors\x18\x02 \x03(\x0b\x32/.envoy.service.ratelimit.v3.RateLimitDescriptor\x12\x13\n\x0bhits_addend\x18\x03 \x01(\r\"\xd1\x04\n\x11RateLimitResponse\x12H\n\x0coverall_code\x18\x01 \x01(\x0e\x32\x32.envoy.service.ratelimit.v3.RateLimitResponse.Code\x12P\n\x08statuses\x18\x02 \x03(\x0b\x32>.envoy.service.ratelimit.v3.RateLimitResponse.DescriptorStatus\x1a\xb2\x01\n\tRateLimit\x12\x19\n\x11requests_per_unit\x18\x01 \x01(\r\x12J\n\x04unit\x18\x02 \x01(\x0e\x32<.envoy.service.ratelimit.v3.RateLimitResponse.RateLimit.Unit\">\n\x04Unit\x12\x0b\n\x07UNKNOWN\x10\x00\x12\n\n\x06SECOND\x10\x01\x12\n\n\x06MINUTE\x10\x02\x12\x08\n\x04HOUR\x10\x03\x12\x07\n\x03\x44\x41Y\x10\x04\x1a\xbd\x01\n\x10\x44\x65scriptorStatus\x12@\n\x04\x63ode\x18\x01 \x01(\x0e\x32\x32.envoy.service.ratelimit.v3.RateLimitResponse.Code\x12N\n\rcurrent_limit\x18\x02 \x01(\x0b\x32\x37.envoy.service.ratelimit.v3.RateLimitResponse.RateLimit\x12\x17\n\x0flimit_remaining\x18\x03 \x01(\r\"+\n\x04\x43ode\x12\x0b\n\x07UNKNOWN\x10\x00\x12\x06\n\x02OK\x10\x01\x12\x0e\n\nOVER_LIMIT\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'envoy_rls_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RATELIMITDESCRIPTOR._serialized_start=48
  _RATELIMITDESCRIPTOR._serialized_end=178
  _RATELIMITDESCRIPTOR_ENTRY._serialized_start=143
  _RATELIMITDESCRIPTOR_ENTRY._serialized_end=178
  _RATELIMITREQUEST._serialized_start=180
  _RATELIMITREQUEST._serialized_end=305
  _RATELIMITRESPONSE._serialized_start=308
  _RATELIMITRESPONSE._serialized_end=901
  _RATELIMITRESPONSE_RATELIMIT._serialized_start=486
  _RATELIMITRESPONSE_RATELIMIT._serialized_end=664
  _RATELIMITRESPONSE_RATELIMIT_UNIT._serialized_start=602
  _RATELIMITRESPONSE_RATELIMIT_UNIT._serialized_end=664
  _RATELIMITRESPONSE_DESCRIPTORSTATUS._serialized_start=667
  _RATELIMITRESPONSE_DESCRIPTORSTATUS._serialized_end=856
  _RATELIMITRESPONSE_CODE._serialized_start=858
  _RATELIMITRESPONSE_CODE._serialized_end=901
# @@protoc_insertion_point(module_scope)
