# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: token_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13token_service.proto\x12\x13sentinel.cluster.v1\"U\n\x0cTokenRequest\x12\x0f\n\x07\x66low_id\x18\x01 \x01(\x03\x12\x0f\n\x07\x61\x63quire\x18\x02 \x01(\x05\x12\x13\n\x0bprioritized\x18\x03 \x01(\x08\x12\x0e\n\x06params\x18\x04 \x03(\t\"[\n\x11\x42\x61tchTokenRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x33\n\x08requests\x18\x02 \x03(\x0b\x32!.sentinel.cluster.v1.TokenRequest\"C\n\rTokenResponse\x12\x0e\n\x06status\x18\x01 \x01(\x05\x12\x0f\n\x07wait_ms\x18\x02 \x01(\x05\x12\x11\n\tremaining\x18\x03 \x01(\x05\"K\n\x12\x42\x61tchTokenResponse\x12\x35\n\tresponses\x18\x01 \x03(\x0b\x32\".sentinel.cluster.v1.TokenResponse2p\n\x0cTokenService\x12`\n\rRequestTokens\x12&.sentinel.cluster.v1.BatchTokenRequest\x1a\'.sentinel.cluster.v1.BatchTokenResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'token_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TOKENREQUEST._serialized_start=44
  _TOKENREQUEST._serialized_end=129
  _BATCHTOKENREQUEST._serialized_start=131
  _BATCHTOKENREQUEST._serialized_end=222
  _TOKENRESPONSE._serialized_start=224
  _TOKENRESPONSE._serialized_end=291
  _BATCHTOKENRESPONSE._serialized_start=293
  _BATCHTOKENRESPONSE._serialized_end=368
  _TOKENSERVICE._serialized_start=370
  _TOKENSERVICE._serialized_end=482
# @@protoc_insertion_point(module_scope)
