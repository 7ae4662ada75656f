"""Shared gRPC service plumbing: method table + signal (de)serialization.

Counterpart of the JAX package's ``comm/service.py``. The handful of methods
are registered by hand from the descriptor
(``grpc.method_handlers_generic_handler``), which is what a generated
``_pb2_grpc.py`` would do; the messages are protoc-generated
(``master_service_pb2.py``, source: ``proto/master_service.proto``). Every
recorder signal becomes one ``corbo_tpu.Signal`` message on the stream (a
matrix signal one message per matrix). Signals are numpy on the host: the
recorder already holds host arrays.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

from control_box_rst_tpu_torch.comm import master_service_pb2 as pb

SERVICE_NAME = "corbo_tpu.MasterService"

# method name → (request class, response class, server-streaming?)
METHODS: Dict[str, Tuple[type, type, bool]] = {
    "setPlant": (pb.ComponentConfig, pb.Status, False),
    "getPlant": (pb.Void, pb.ComponentConfig, False),
    "setController": (pb.ComponentConfig, pb.Status, False),
    "getController": (pb.Void, pb.ComponentConfig, False),
    "setObserver": (pb.ComponentConfig, pb.Status, False),
    "getObserver": (pb.Void, pb.ComponentConfig, False),
    "setTask": (pb.ComponentConfig, pb.Status, False),
    "getTask": (pb.Void, pb.ComponentConfig, False),
    "getAvailableSignals": (pb.Void, pb.Signal, True),
    "performTask": (pb.Void, pb.Signal, True),
    "verifyConfig": (pb.Void, pb.Status, False),
    "ping": (pb.Void, pb.Status, False),
    "stop": (pb.Void, pb.Void, False),
}


def signal_to_protos(name: str, sig: dict) -> Iterable[pb.Signal]:
    """Convert one SignalRecorder entry into Signal messages.

    `sig` is the recorder's dict form (core/signals.py): kind plus
    times/values/indices/matrices fields depending on kind.
    """
    kind = sig.get("kind", "time_series")
    msg = pb.Signal()
    msg.header.name = name
    msg.header.kind = kind
    if kind in ("measurement", "time_series"):
        times = np.asarray(sig.get("times", []), dtype=np.float64)
        values = np.asarray(sig.get("values", []), dtype=np.float64)
        msg.times.extend(times.ravel().tolist())
        msg.header.shape.extend(values.shape)
        msg.values.extend(values.ravel().tolist())
        if times.size:
            msg.header.time = float(times.ravel()[-1])
        yield msg
    elif kind == "indexed":
        values = np.asarray(sig.get("values", []), dtype=np.float64)
        msg.indices.extend(int(i) for i in sig.get("indices", []))
        msg.header.shape.extend(values.shape)
        msg.values.extend(values.ravel().tolist())
        yield msg
    elif kind == "matrix":
        # one Signal per matrix (matrices may have different shapes)
        for i, m in enumerate(sig.get("matrices", [])):
            m = np.asarray(m, dtype=np.float64)
            out = pb.Signal()
            out.header.name = name
            out.header.kind = kind
            out.header.shape.extend(m.shape)
            out.indices.append(i)
            out.values.extend(m.ravel().tolist())
            yield out
    else:  # header-only / unknown kinds still announce themselves
        yield msg


def proto_to_signal(msg: pb.Signal) -> Tuple[str, dict]:
    """Inverse of signal_to_protos (client side)."""
    shape = tuple(msg.header.shape)
    values = np.asarray(msg.values, dtype=np.float64)
    if shape:
        values = values.reshape(shape)
    sig = {"kind": msg.header.kind or "time_series", "name": msg.header.name}
    if msg.header.kind == "matrix":
        sig["matrices"] = [values]
        sig["indices"] = list(msg.indices)
    elif msg.header.kind == "indexed":
        sig["values"] = values
        sig["indices"] = list(msg.indices)
    else:
        sig["times"] = np.asarray(msg.times, dtype=np.float64)
        sig["values"] = values
    return msg.header.name, sig


def merge_signal(store: dict, name: str, sig: dict) -> None:
    """Accumulate a streamed Signal into a client-side signal dict
    (matrix signals arrive as one message per matrix)."""
    if sig["kind"] == "matrix" and name in store:
        store[name]["matrices"].extend(sig["matrices"])
        store[name]["indices"].extend(sig["indices"])
    else:
        store[name] = sig
