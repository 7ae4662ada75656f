"""Blocking master-service client.

Counterpart of the JAX package's ``comm/client.py``: the thin blocking
wrapper over the MasterService channel that the dashboard and scripts use.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import grpc
import yaml

from control_box_rst_tpu_torch.comm import master_service_pb2 as pb
from control_box_rst_tpu_torch.comm.service import (
    METHODS,
    SERVICE_NAME,
    merge_signal,
    proto_to_signal,
)


class MasterClient:
    """Thin blocking wrapper over the MasterService channel."""

    def __init__(self, address: str = "localhost:50051",
                 channel: Optional[grpc.Channel] = None):
        self._channel = channel or grpc.insecure_channel(address)
        self._stubs = {}
        for name, (req_cls, resp_cls, streaming) in METHODS.items():
            make = (
                self._channel.unary_stream if streaming else self._channel.unary_unary
            )
            self._stubs[name] = make(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            )

    def close(self) -> None:
        self._channel.close()

    # -- config ---------------------------------------------------------------
    def _set(self, method: str, kind: str, fragment: dict) -> pb.Status:
        cfg = pb.ComponentConfig(kind=kind, yaml=yaml.safe_dump(fragment))
        return self._stubs[method](cfg)

    def set_plant(self, fragment: dict) -> pb.Status:
        return self._set("setPlant", "plant", fragment)

    def set_controller(self, fragment: dict) -> pb.Status:
        return self._set("setController", "controller", fragment)

    def set_observer(self, fragment: dict) -> pb.Status:
        return self._set("setObserver", "observer", fragment)

    def set_task(self, fragment: dict) -> pb.Status:
        return self._set("setTask", "task", fragment)

    def set_config(self, config: dict) -> pb.Status:
        """Send a full experiment config (replaces every section;
        analogue of Master::loadFromFile on .cparams, master.h:85-87)."""
        return self._set("setTask", "config", config)

    def get_section(self, kind: str) -> dict:
        method = {"plant": "getPlant", "controller": "getController",
                  "observer": "getObserver", "task": "getTask"}[kind]
        resp = self._stubs[method](pb.Void())
        return yaml.safe_load(resp.yaml) or {}

    # -- control --------------------------------------------------------------
    def ping(self) -> bool:
        try:
            return self._stubs["ping"](pb.Void(), timeout=2.0).ok
        except grpc.RpcError:
            return False

    def verify_config(self) -> Tuple[bool, str]:
        st = self._stubs["verifyConfig"](pb.Void())
        return st.ok, st.text

    def stop(self) -> None:
        self._stubs["stop"](pb.Void())

    # -- signals ---------------------------------------------------------------
    def available_signals(self) -> Dict[str, str]:
        """name → kind for the signals the configured task will emit."""
        return {
            msg.header.name: msg.header.kind
            for msg in self._stubs["getAvailableSignals"](pb.Void())
        }

    def perform_task_stream(self) -> Iterator[pb.Signal]:
        """Raw streaming iterator over performTask."""
        return self._stubs["performTask"](pb.Void())

    def perform_task(self) -> Dict[str, dict]:
        """Run the configured task; collect streamed signals into a dict
        of recorder-style signal entries keyed by name."""
        store: Dict[str, dict] = {}
        for msg in self.perform_task_stream():
            name, sig = proto_to_signal(msg)
            merge_signal(store, name, sig)
        return store
