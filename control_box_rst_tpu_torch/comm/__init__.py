"""Communication layer: gRPC master service + client.

Counterpart of the JAX package's ``comm/``: the reference's protobuf schema
and gRPC plumbing. Strictly a control and telemetry plane: nothing here
touches the numeric hot path. ``master_service_pb2.py`` and
``proto/master_service.proto`` are byte-for-byte copies of the JAX package's
(same file name, proto package ``corbo_tpu``), so the wire is the same and
both packages' messages share one descriptor pool when they meet in one
process. The package's top-level ``__init__`` does not import this one, so
the port imports where ``grpc`` is absent.
"""
from control_box_rst_tpu_torch.comm import master_service_pb2 as pb
from control_box_rst_tpu_torch.comm.client import MasterClient
from control_box_rst_tpu_torch.comm.server import MasterServer, serve
from control_box_rst_tpu_torch.comm.service import (
    SERVICE_NAME,
    proto_to_signal,
    signal_to_protos,
)

__all__ = [
    "pb",
    "MasterClient",
    "MasterServer",
    "serve",
    "SERVICE_NAME",
    "signal_to_protos",
    "proto_to_signal",
]
