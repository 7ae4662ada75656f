"""gRPC master server.

Counterpart of the JAX package's ``comm/server.py``: a service that holds
the experiment configuration as YAML sections, rebuilds and verifies it
through the same ``core/config.py`` builders the CLI uses, runs the task and
streams the recorded signal tree back. A "master/progress" measurement
brackets the run (0.0 before, 1.0 after) so clients see liveness; the stream
never interleaves with the device work.

``MasterServer(device=None, dtype=None)`` resolves its device once, at
construction: ``None`` means the card and raises when there is none, so a
CPU server has to be asked for. Every task it runs, and every build it
verifies, runs on that device in that dtype (``None``: float32).
"""
from __future__ import annotations

import threading
import traceback
from typing import Dict, Iterator, Optional

import grpc
import yaml

from control_box_rst_tpu_torch.comm import master_service_pb2 as pb
from control_box_rst_tpu_torch.comm.service import METHODS, SERVICE_NAME, signal_to_protos
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype

_SECTION_KINDS = ("plant", "controller", "observer", "task")

# config top-level keys owned by each section (setX replaces exactly these)
_SECTION_KEYS = {
    "plant": ("plant",),
    "controller": (
        "controller", "solver", "system", "grid", "cost", "bounds",
        "x0", "xf", "xf_fixed",
    ),
    "observer": ("observer",),
    "task": ("experiment",),
}


class MasterServer:
    """Holds the experiment configuration; builds/verifies/runs it."""

    def __init__(self, device=None, dtype=None):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self._lock = threading.Lock()
        self._sections: Dict[str, dict] = {k: {} for k in _SECTION_KINDS}
        self._running = False

    # -- config management ---------------------------------------------------
    def set_section(self, kind: str, yaml_text: str) -> pb.Status:
        if kind == "config":
            try:
                cfg = yaml.safe_load(yaml_text) or {}
            except yaml.YAMLError as e:
                return pb.Status(ok=False, text=f"YAML parse error: {e}")
            with self._lock:
                for sect in _SECTION_KINDS:
                    self._sections[sect] = {
                        k: cfg[k] for k in _SECTION_KEYS[sect] if k in cfg
                    }
            return pb.Status(ok=True, text="full config accepted")
        if kind not in _SECTION_KINDS:
            return pb.Status(ok=False, text=f"unknown config kind {kind!r}")
        try:
            frag = yaml.safe_load(yaml_text) or {}
        except yaml.YAMLError as e:
            return pb.Status(ok=False, text=f"YAML parse error: {e}")
        allowed = set(_SECTION_KEYS[kind])
        unknown = set(frag) - allowed
        if unknown:
            return pb.Status(
                ok=False,
                text=f"keys {sorted(unknown)} not valid for section {kind!r} "
                f"(allowed: {sorted(allowed)})",
            )
        with self._lock:
            self._sections[kind] = frag
        return pb.Status(ok=True, text=f"{kind} config accepted")

    def get_section(self, kind: str) -> pb.ComponentConfig:
        with self._lock:
            frag = dict(self._sections.get(kind, {}))
        return pb.ComponentConfig(kind=kind, yaml=yaml.safe_dump(frag))

    def full_config(self) -> dict:
        with self._lock:
            cfg: dict = {}
            for sect in _SECTION_KINDS:
                cfg.update(self._sections[sect])
        return cfg

    def verify(self) -> pb.Status:
        """Build the full environment on the server's device and
        dimension-check it."""
        cfg = self.full_config()
        if not cfg.get("system"):
            return pb.Status(ok=False, text="no system configured")
        try:
            from control_box_rst_tpu_torch.core.config import build_controller, build_system
            from control_box_rst_tpu_torch.sim import SimulatedPlant
            from control_box_rst_tpu_torch.sim.environment import Environment

            controller, system = build_controller(cfg, self.dtype, self.device)
            plant_cfg = cfg.get("plant", {})
            plant_system = (
                build_system(plant_cfg["system"])
                if "system" in plant_cfg
                else system
            )
            env = Environment(controller, SimulatedPlant(system=plant_system))
            ok_, issues = env.verify()
            if not ok_:
                return pb.Status(ok=False, text="; ".join(issues))
            return pb.Status(ok=True, text="config verified")
        except Exception as e:  # config errors surface as status, not crashes
            return pb.Status(ok=False, text=f"{type(e).__name__}: {e}")

    # -- task execution -------------------------------------------------------
    def available_signals(self) -> Iterator[pb.Signal]:
        """Announce the signals the configured task will emit (header-only)."""
        task = self.full_config().get("experiment", {}).get("task", "closed_loop")
        names = {
            "closed_loop": (
                "plant_output", "observed_states", "applied_controls",
                "plant_states", "controller/objective", "controller/sqp_iters",
                "controller/qp_iters", "controller/stat_res",
                "controller/feas_res", "controller/n_active", "controller/dts",
            ),
            "open_loop": ("planned_states", "planned_controls", "rollout_states"),
            "benchmark_varying_x0": (
                "benchmark/x0_grid", "benchmark/final_states", "benchmark/controls",
            ),
            "benchmark_increasing_n": ("benchmark/n_values", "benchmark/solve_times"),
        }.get(task, ())
        for n in names:
            msg = pb.Signal()
            msg.header.name = n
            msg.header.kind = "time_series" if "/" not in n or n.startswith("controller") else "matrix"
            yield msg

    def perform_task(self, context: Optional[grpc.ServicerContext] = None
                     ) -> Iterator[pb.Signal]:
        from control_box_rst_tpu_torch.core.config import run_experiment

        with self._lock:
            if self._running:
                if context is not None:
                    context.abort(
                        grpc.StatusCode.FAILED_PRECONDITION, "task already running"
                    )
                return
            self._running = True
        try:
            start = pb.Signal()
            start.header.name = "master/progress"
            start.header.kind = "measurement"
            start.values.append(0.0)
            yield start

            cfg = self.full_config()
            rec = run_experiment(cfg, device=self.device, dtype=self.dtype)
            for name in sorted(rec.names()):
                for msg in signal_to_protos(name, rec.get(name)):
                    yield msg

            done = pb.Signal()
            done.header.name = "master/progress"
            done.header.kind = "measurement"
            done.values.append(1.0)
            yield done
        except Exception:
            if context is not None:
                context.abort(grpc.StatusCode.INTERNAL, traceback.format_exc())
            raise
        finally:
            with self._lock:
                self._running = False

    def stop(self) -> None:
        from control_box_rst_tpu_torch.core.console import set_ok

        set_ok(False)

    # -- gRPC wiring -----------------------------------------------------------
    def grpc_handler(self) -> grpc.GenericRpcHandler:
        """Register the RPC method table (what protoc's grpc plugin would
        have generated)."""

        def unary(fn):
            return lambda req, ctx: fn(req, ctx)

        impls = {
            "setPlant": lambda r, c: self.set_section(r.kind or "plant", r.yaml),
            "getPlant": lambda r, c: self.get_section("plant"),
            "setController": lambda r, c: self.set_section(
                r.kind or "controller", r.yaml
            ),
            "getController": lambda r, c: self.get_section("controller"),
            "setObserver": lambda r, c: self.set_section(r.kind or "observer", r.yaml),
            "getObserver": lambda r, c: self.get_section("observer"),
            "setTask": lambda r, c: self.set_section(r.kind or "task", r.yaml),
            "getTask": lambda r, c: self.get_section("task"),
            "getAvailableSignals": lambda r, c: self.available_signals(),
            "performTask": lambda r, c: self.perform_task(c),
            "verifyConfig": lambda r, c: self.verify(),
            "ping": lambda r, c: pb.Status(ok=True, text="corbo_tpu master"),
            "stop": lambda r, c: (self.stop(), pb.Void())[1],
        }
        handlers = {}
        for name, (req_cls, resp_cls, streaming) in METHODS.items():
            make = (
                grpc.unary_stream_rpc_method_handler
                if streaming
                else grpc.unary_unary_rpc_method_handler
            )
            handlers[name] = make(
                unary(impls[name]),
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString,
            )
        return grpc.method_handlers_generic_handler(SERVICE_NAME, handlers)


def bound_address(address: str, port: int) -> str:
    """``address`` with the port that ``add_insecure_port`` bound (the
    same text for a fixed port; the chosen one for ``host:0``)."""
    return f"{address.rsplit(':', 1)[0]}:{port}"


def serve(address: str = "localhost:50051", max_workers: int = 4,
          block: bool = True, device=None, dtype=None) -> grpc.Server:
    """Start the master gRPC server on ``device`` (``None``: the card)."""
    from concurrent import futures

    master = MasterServer(device=device, dtype=dtype)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((master.grpc_handler(),))
    port = server.add_insecure_port(address)
    server.start()
    print(f"corbo_tpu master listening on {bound_address(address, port)}", flush=True)
    if block:
        server.wait_for_termination()
    return server
