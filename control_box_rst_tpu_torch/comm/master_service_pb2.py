# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: master_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x14master_service.proto\x12\tcorbo_tpu\"\x06\n\x04Void\"\"\n\x06Status\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0c\n\x04text\x18\x02 \x01(\t\"-\n\x0f\x43omponentConfig\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\x0c\n\x04yaml\x18\x02 \x01(\t\"G\n\x0cSignalHeader\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12\x0c\n\x04time\x18\x03 \x01(\x01\x12\r\n\x05shape\x18\x04 \x03(\x05\"a\n\x06Signal\x12\'\n\x06header\x18\x01 \x01(\x0b\x32\x17.corbo_tpu.SignalHeader\x12\r\n\x05times\x18\x02 \x03(\x01\x12\x0e\n\x06values\x18\x03 \x03(\x01\x12\x0f\n\x07indices\x18\x04 \x03(\x05\x32\x83\x06\n\rMasterService\x12;\n\x08setPlant\x12\x1a.corbo_tpu.ComponentConfig\x1a\x11.corbo_tpu.Status\"\x00\x12\x39\n\x08getPlant\x12\x0f.corbo_tpu.Void\x1a\x1a.corbo_tpu.ComponentConfig\"\x00\x12@\n\rsetController\x12\x1a.corbo_tpu.ComponentConfig\x1a\x11.corbo_tpu.Status\"\x00\x12>\n\rgetController\x12\x0f.corbo_tpu.Void\x1a\x1a.corbo_tpu.ComponentConfig\"\x00\x12>\n\x0bsetObserver\x12\x1a.corbo_tpu.ComponentConfig\x1a\x11.corbo_tpu.Status\"\x00\x12<\n\x0bgetObserver\x12\x0f.corbo_tpu.Void\x1a\x1a.corbo_tpu.ComponentConfig\"\x00\x12:\n\x07setTask\x12\x1a.corbo_tpu.ComponentConfig\x1a\x11.corbo_tpu.Status\"\x00\x12\x38\n\x07getTask\x12\x0f.corbo_tpu.Void\x1a\x1a.corbo_tpu.ComponentConfig\"\x00\x12=\n\x13getAvailableSignals\x12\x0f.corbo_tpu.Void\x1a\x11.corbo_tpu.Signal\"\x00\x30\x01\x12\x35\n\x0bperformTask\x12\x0f.corbo_tpu.Void\x1a\x11.corbo_tpu.Signal\"\x00\x30\x01\x12\x34\n\x0cverifyConfig\x12\x0f.corbo_tpu.Void\x1a\x11.corbo_tpu.Status\"\x00\x12,\n\x04ping\x12\x0f.corbo_tpu.Void\x1a\x11.corbo_tpu.Status\"\x00\x12*\n\x04stop\x12\x0f.corbo_tpu.Void\x1a\x0f.corbo_tpu.Void\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'master_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VOID._serialized_start=35
  _VOID._serialized_end=41
  _STATUS._serialized_start=43
  _STATUS._serialized_end=77
  _COMPONENTCONFIG._serialized_start=79
  _COMPONENTCONFIG._serialized_end=124
  _SIGNALHEADER._serialized_start=126
  _SIGNALHEADER._serialized_end=197
  _SIGNAL._serialized_start=199
  _SIGNAL._serialized_end=296
  _MASTERSERVICE._serialized_start=299
  _MASTERSERVICE._serialized_end=1070
# @@protoc_insertion_point(module_scope)
