"""Experiment configuration: the YAML / dict loader.

Counterpart of the JAX package's ``core/config.py``: a plain dict (or YAML
file) names every component by a ``type:`` key; the builders here turn it
into the port's own objects (system, grid, cost, terminal constraint, OCP,
plant, observer, controller), and ``run_experiment`` runs the configured
task and returns a ``SignalRecorder`` with the reference's signal names.
Every branch of the reference's loader is here, with its defaults, and each
builds what the reference's builds — config 6's ``integral: true`` quadratic
form included, which ends up inside a ``CompositeCost`` whose own
``integral`` stays False (the transcription reads the composite's).

Every builder takes ``dtype`` (``None`` means float32) and ``device``
(``None`` means the card, and raises when there is none; the CPU has to be
asked for). A controller's LQR and Kalman gains are computed on the host in
float64 and then moved there.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from control_box_rst_tpu_torch.core.factory import Factory
from control_box_rst_tpu_torch.core.signals import SignalRecorder
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype
from control_box_rst_tpu_torch.utils.tree import plain_dataclass, tree_to


def _arr(v) -> Optional[torch.Tensor]:
    """A float64 host tensor of a YAML number or (nested) list, or None."""
    return None if v is None else torch.as_tensor(np.asarray(v, dtype=np.float64))


def build_system(cfg: Dict[str, Any]):
    """{'type': 'van_der_pol', 'params': {...}} → a system of
    ``models/benchmark.py`` (list parameters become float64 host tensors;
    whatever holds the system moves them)."""
    import control_box_rst_tpu_torch.models.benchmark  # noqa: F401 (registers)

    params = dict(cfg.get("params", {}))
    typ = cfg["type"]
    if typ == "linear_state_space":
        from control_box_rst_tpu_torch.models import LinearStateSpaceModel

        return LinearStateSpaceModel.from_matrices(
            np.asarray(params["A"]), np.asarray(params["B"])
        )
    for k, v in list(params.items()):
        if isinstance(v, (list, tuple)):
            params[k] = _arr(v)
    return Factory.create("system", typ, **params)


def build_grid(cfg: Dict[str, Any]):
    from control_box_rst_tpu_torch.ocp import grids

    typ = cfg.get("type", "fd")
    N = int(cfg.get("N", 20))
    fd = lambda: (cfg.get("fd_scheme", "crank_nicolson"),
                  cfg.get("cost_integration", "left_sum"))
    ms = lambda: (cfg.get("integrator", "rk4"), cfg.get("substeps", 1),
                  cfg.get("cost_integration", "left_sum"))
    if typ == "fd":
        return grids.finite_differences_grid(N, *fd())
    if typ == "fd_variable":
        return grids.finite_differences_variable_grid(N, *fd())
    if typ == "fd_variable_non_uniform":
        return grids.non_uniform_fd_variable_grid(N, *fd())
    if typ == "multiple_shooting":
        return grids.multiple_shooting_grid(N, *ms())
    if typ == "multiple_shooting_variable":
        return grids.multiple_shooting_variable_grid(N, *ms())
    if typ == "multiple_shooting_variable_non_uniform":
        return grids.non_uniform_multiple_shooting_variable_grid(N, *ms())
    if typ == "move_blocking":
        return grids.move_blocking_grid(
            N, cfg["blocks"], cfg.get("fd_scheme", "crank_nicolson"),
        )
    if typ == "hermite_simpson_uncompressed":
        return grids.hermite_simpson_uncompressed_grid(N)
    raise KeyError(f"unknown grid type {typ!r}")


@plain_dataclass
class SoftBoxRows:
    """The rows [lo − x, x − hi] ≤ 0 of the L1 soft state bounds (a
    dataclass, so that ``tree_to`` moves lo and hi with the OCP)."""

    lo: torch.Tensor = None
    hi: torch.Tensor = None

    def __call__(self, x, u):
        return torch.cat([self.lo - x, x - self.hi], dim=-1)


def build_cost(cfg: Dict[str, Any], nx: int, nu: int):
    from control_box_rst_tpu_torch.ocp import costs as C

    typ = cfg.get("type", "quadratic_form")
    integral = bool(cfg.get("integral", False))
    parts = []
    if typ == "quadratic_form":
        parts.append(C.QuadraticFormCost(
            Q=_arr(cfg.get("Q", np.eye(nx))), R=_arr(cfg.get("R", 0.1 * np.eye(nu))),
            integral=integral))
    elif typ == "quadratic_state":
        parts.append(C.QuadraticStateCost(Q=_arr(cfg.get("Q", np.eye(nx))), integral=integral))
    elif typ == "quadratic_control":
        parts.append(C.QuadraticControlCost(R=_arr(cfg.get("R", np.eye(nu))), integral=integral))
    elif typ == "minimum_time":
        parts.append(C.MinimumTime(
            weight=float(cfg.get("weight", 1.0)),
            lsq_form=bool(cfg.get("lsq_form", False)),
        ))
    elif typ == "minimum_time_regularized":
        parts.append(C.MinimumTimeRegularized(
            weight=float(cfg.get("weight", 1.0)), reg=float(cfg.get("reg", 1e-3))))
    elif typ == "min_time_quadratic":
        parts.append(C.MinTimeQuadratic(
            time_weight=float(cfg.get("time_weight", 1.0)),
            Q=_arr(cfg.get("Q")), R=_arr(cfg.get("R")),
        ))
    elif typ == "min_time_quadratic_gain_scheduled":
        parts.append(C.MinTimeQuadraticGainScheduled(
            time_weight=float(cfg.get("time_weight", 1.0)),
            Q=_arr(cfg.get("Q")), R=_arr(cfg.get("R")),
            radius=float(cfg.get("radius", 1.0)),
            sharpness=float(cfg.get("sharpness", 10.0)),
        ))
    else:
        raise KeyError(f"unknown cost type {typ!r}")
    if cfg.get("Qf") is not None:
        parts.append(C.QuadraticFinalStateCost(Qf=_arr(cfg["Qf"])))
    # L1 soft state bounds as an additional exact-penalty term
    if cfg.get("soft_x_min") is not None or cfg.get("soft_x_max") is not None:
        from control_box_rst_tpu_torch.ocp import FunctionalStageConstraint

        rows = SoftBoxRows(lo=_arr(cfg.get("soft_x_min", np.full(nx, -np.inf))),
                           hi=_arr(cfg.get("soft_x_max", np.full(nx, np.inf))))
        parts.append(C.L1SoftConstraintCost(
            constraint=FunctionalStageConstraint(nineq=2 * nx, ineq_fn=rows),
            weight=float(cfg.get("soft_weight", 10.0)),
        ))
    if len(parts) == 1:
        return parts[0]
    # the composite's own integral stays False, as the reference builds it
    return C.CompositeCost(costs=tuple(parts))


def build_terminal_constraint(config: Dict[str, Any], nx: int):
    """constraints: section → a terminal constraint (None if absent).

    YAML forms:
      constraints: {terminal_ball: {S: [[..]], gamma: 0.1}}
      constraints: {terminal_equality: true}            # x_N == xf
      constraints: {terminal_partial_equality: [0]}     # component indices
    """
    cc = config.get("constraints")
    if not cc:
        return None
    from control_box_rst_tpu_torch.ocp import (
        TerminalBall,
        terminal_equality,
        terminal_partial_equality,
    )

    if "terminal_ball" in cc:
        tb = cc["terminal_ball"]
        return TerminalBall(S=_arr(tb.get("S", np.eye(nx))), gamma=float(tb.get("gamma", 1.0)))
    if cc.get("terminal_equality"):
        return terminal_equality(nx)
    if "terminal_partial_equality" in cc:
        return terminal_partial_equality(cc["terminal_partial_equality"])
    raise KeyError(f"unknown constraints spec: {sorted(cc)}")


def build_ocp(config: Dict[str, Any], dtype=None, device=None):
    """(TranscribedOCP on ``device`` as ``dtype``, the system)."""
    from control_box_rst_tpu_torch.ocp import Bounds, transcribe

    dtype, device = resolve_dtype(dtype), resolve_device(device)
    system = build_system(config["system"])
    grid = build_grid(config.get("grid", {}))
    cost = build_cost(config.get("cost", {}), system.nx, system.nu)
    b = config.get("bounds", {})
    # float32 first, as the reference's loader builds them (its
    # Bounds.unbounded defaults to float32, x64 or not): a bound such as
    # dt_min 1e-3 carries float32's rounding into a float64 run too
    bounds = Bounds.unbounded(system.nx, system.nu, torch.float32, device)
    if "u_min" in b or "u_max" in b:
        bounds = bounds.with_u(b.get("u_min", -np.inf), b.get("u_max", np.inf))
    if "x_min" in b or "x_max" in b:
        bounds = bounds.with_x(b.get("x_min", -np.inf), b.get("x_max", np.inf))
    if "dt_min" in b or "dt_max" in b:
        bounds = bounds.with_dt(b.get("dt_min", 0.0), b.get("dt_max", np.inf))
    xf_fixed = config.get("xf_fixed")
    ocp = transcribe(
        system, grid, cost,
        bounds=bounds,
        x0=_arr(config.get("x0", np.zeros(system.nx))),
        xf=_arr(config.get("xf")),
        xf_fixed=_arr(xf_fixed) if xf_fixed is not None else None,
        term_con=build_terminal_constraint(config, system.nx),
        dtype=dtype, device=device,
    )
    return ocp, system


def build_plant(config: Dict[str, Any], default_system, dtype=None, device=None):
    """plant: section → SimulatedPlant on ``device`` as ``dtype``.

    YAML:
      plant:
        system: {type: ...}          # defaults to the controller's model
        integrator: {type: rk4, substeps: 4}
        output: full | first         # or a C matrix (list of lists)
        noise: {state_std: 0.0, output_std: 0.0, input_std: 0.0}
        x0: [..]                     # plant-side initial state override
    """
    from control_box_rst_tpu_torch.ops.integrators import make_integrator
    from control_box_rst_tpu_torch.sim import GaussianNoise, SimulatedPlant

    pc = config.get("plant", {})
    system = build_system(pc["system"]) if "system" in pc else default_system
    integ_cfg = pc.get("integrator", {})
    integrator = make_integrator(
        integ_cfg.get("type", "rk4"), int(integ_cfg.get("substeps", 4))
    )
    out = pc.get("output", "full")
    if isinstance(out, str):
        output_kind, C = out, None
    else:
        output_kind, C = "linear", _arr(out)
    noise = pc.get("noise", {})

    def _noise(key):
        std = float(noise.get(key, 0.0))
        return GaussianNoise(std=std) if std > 0.0 else None

    plant = SimulatedPlant(
        system=system,
        integrator=integrator,
        output_kind=output_kind,
        C=C,
        state_noise=_noise("state_std"),
        output_noise=_noise("output_std"),
        input_noise=_noise("input_std"),
    )
    return tree_to(plant, resolve_device(device), resolve_dtype(dtype))


def build_observer(config: Dict[str, Any], plant, dtype=None, device=None):
    """observer: section → observer.

    YAML:
      observer: {type: none}
      observer: {type: kalman, W: [[..]], V: [[..]]}   # steady-state KF on
        the plant's linearization at the origin, ZOH-discretized at dt
    """
    from control_box_rst_tpu_torch.sim.observer import (
        NoObserver,
        SteadyStateKalmanObserver,
    )

    oc = config.get("observer", {"type": "none"})
    typ = oc.get("type", "none")
    if typ in ("none", "no_observer"):
        return NoObserver()
    if typ == "kalman":
        dt = float(config.get("experiment", {}).get("dt", 0.1))
        return SteadyStateKalmanObserver.from_plant(
            plant, dt, W=_arr(oc.get("W")), V=_arr(oc.get("V")), dtype=dtype, device=device)
    raise KeyError(f"unknown observer type {typ!r}")


_ADAPTATION_KINDS = {
    "time_based_single_step": "TimeBasedSingleStep",
    "time_based_aggressive": "TimeBasedAggressiveEstimate",
    "shrinking_horizon": "SimpleShrinkingHorizon",
    "redundant_controls": "RedundantControls",
    "grow_on_infeasibility": "GrowOnInfeasibility",
}


def build_controller(config: Dict[str, Any], dtype=None, device=None):
    """(controller on ``device`` as ``dtype``, the system)."""
    from control_box_rst_tpu_torch.control import (
        LqrController,
        PidController,
        PredictiveController,
    )
    from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

    dtype, device = resolve_dtype(dtype), resolve_device(device)
    ctrl_cfg = config.get("controller", {"type": "predictive"})
    typ = ctrl_cfg.get("type", "predictive")
    ocp, system = build_ocp(config, dtype, device)
    on_device = lambda c: c.to(device, dtype)
    if typ == "predictive":
        s = config.get("solver", {})
        solver_type = s.get("type", "sqp")
        cfg = SQPConfig(
            max_iter=int(s.get("max_iter", 10)),
            qp=QPConfig(
                max_iter=int(s.get("qp_max_iter", 200)),
                tol=float(s.get("qp_tol", 1e-8)),
            ),
            tol_stat=float(s.get("tol_stat", 1e-6)),
            tol_feas=float(s.get("tol_feas", 1e-7)),
        )
        ip_cfg = None
        lm_cfg = None
        if solver_type == "ip":
            from control_box_rst_tpu_torch.solvers import IPConfig

            ip_cfg = IPConfig(
                max_iter=int(s.get("max_iter", 60)),
                tol=(float(s["tol"]) if "tol" in s else None),
                mu_init=float(s.get("mu_init", 1e-1)),
            )
        elif solver_type == "lm":
            from control_box_rst_tpu_torch.solvers import LMConfig

            lm_cfg = LMConfig(
                max_iter=int(s.get("max_iter", 50)),
                mu_init=float(s.get("mu_init", 1e-4)),
                feas_tol=float(s.get("tol_feas", 1e-6)),
            )
        adaptation = None
        a = ctrl_cfg.get("adaptation")
        if a:
            from control_box_rst_tpu_torch.ocp import adaptation as A

            kind = getattr(A, _ADAPTATION_KINDS[a["type"]])
            adaptation = kind(**{k: v for k, v in a.items() if k != "type"})
        return (
            PredictiveController(
                nx=system.nx, nu=system.nu, ocp=ocp,
                dt=float(config.get("experiment", {}).get("dt", 0.1)),
                cfg=cfg, solver=solver_type, ip_cfg=ip_cfg, lm_cfg=lm_cfg,
                adaptation=adaptation,
                warm_start_shift=bool(ctrl_cfg.get("warm_start_shift", True)),
                n_active_init=int(ctrl_cfg.get("n_active_init", 0)),
                device=device, dtype=dtype,
            ),
            system,
        )
    if typ == "lqr":
        return (
            LqrController.from_system(
                system, _arr(ctrl_cfg.get("Q", np.eye(system.nx))),
                _arr(ctrl_cfg.get("R", np.eye(system.nu))),
                xref=_arr(config.get("xf")), dtype=dtype, device=device,
            ),
            system,
        )
    if typ == "pid":
        return (
            on_device(PidController(
                nx=system.nx, nu=system.nu,
                p_gain=float(ctrl_cfg.get("p_gain", 1.0)),
                i_gain=float(ctrl_cfg.get("i_gain", 0.0)),
                d_gain=float(ctrl_cfg.get("d_gain", 0.0)),
                xref=_arr(config.get("xf")),
            )),
            system,
        )
    if typ == "simple_state":
        from control_box_rst_tpu_torch.control import SimpleStateController

        return (
            on_device(SimpleStateController(
                nx=system.nx, nu=system.nu,
                K=_arr(ctrl_cfg["K"]),
                V=_arr(ctrl_cfg.get("V")),
                xref=_arr(config.get("xf")),
                uref=_arr(ctrl_cfg.get("uref")),
            )),
            system,
        )
    if typ == "step_response":
        from control_box_rst_tpu_torch.control import StepResponseGenerator

        return (
            on_device(StepResponseGenerator(
                nx=system.nx, nu=system.nu,
                u_step=_arr(ctrl_cfg.get("u_step", np.ones(system.nu))),
                u_init=_arr(ctrl_cfg.get("u_init")),
                t_step=float(ctrl_cfg.get("t_step", 0.0)),
            )),
            system,
        )
    if typ == "dual_mode":
        # MPC far from the goal, LQR inside the terminal ball. YAML:
        #   controller: {type: dual_mode, local: {Q: .., R: ..},
        #                S: [[..]], gamma: 0.1, latch: true}
        from control_box_rst_tpu_torch.control import DualModeController

        inner = dict(config)
        inner["controller"] = {
            k: v for k, v in ctrl_cfg.items()
            if k not in ("type", "local", "S", "gamma", "latch")
        }
        inner["controller"]["type"] = "predictive"
        mpc, _ = build_controller(inner, dtype, device)
        local_cfg = ctrl_cfg.get("local", {})
        xf = _arr(config.get("xf", np.zeros(system.nx)))
        local = LqrController.from_system(
            system,
            _arr(local_cfg.get("Q", np.eye(system.nx))),
            _arr(local_cfg.get("R", np.eye(system.nu))),
            xref=xf, dtype=dtype, device=device,
        )
        cast = lambda a: a.to(device=device, dtype=dtype)
        return (
            DualModeController(
                nx=system.nx, nu=system.nu,
                global_controller=mpc, local_controller=local,
                S=cast(_arr(ctrl_cfg.get("S", np.eye(system.nx)))),
                gamma=float(ctrl_cfg.get("gamma", 0.1)),
                xf=cast(xf),
                latch=bool(ctrl_cfg.get("latch", False)),
            ),
            system,
        )
    raise KeyError(f"unknown controller type {typ!r}")


def run_experiment(config: Dict[str, Any], device=None, dtype=None,
                   generator: Optional[torch.Generator] = None) -> SignalRecorder:
    """Build and run the configured task; returns the recorded signals.

    Tasks: ``closed_loop`` (one rollout from x0: the plant's ``x0`` if it
    names one, else the config's), ``open_loop`` (one solve, the plant
    rolled along the plan), ``benchmark_varying_x0`` (the x01 × x02 grid as
    one batch of rollouts) and ``benchmark_increasing_n`` (one open-loop
    solve per horizon). ``device=None`` means the card and raises when there
    is none; ``dtype=None`` means float32; ``generator`` is what noisy plants
    draw from (on ``device``; ``None`` means one seeded with 0)."""
    from control_box_rst_tpu_torch.sim import run_closed_loop, run_open_loop
    from control_box_rst_tpu_torch.sim.benchmarks import (
        benchmark_increasing_n_open_loop,
        benchmark_varying_initial_state,
    )

    device, dtype = resolve_device(device), resolve_dtype(dtype)
    exp = config.get("experiment", {})
    task = exp.get("task", "closed_loop")
    dt = float(exp.get("dt", 0.1))
    controller, system = build_controller(config, dtype, device)
    plant = build_plant(config, system, dtype, device)
    observer = build_observer(config, plant, dtype, device)
    x0 = _arr(config.get("plant", {}).get("x0", config.get("x0", np.zeros(system.nx))))
    x0 = x0.to(device=device, dtype=dtype)

    rec = SignalRecorder()
    if task == "closed_loop":
        res = run_closed_loop(
            plant, controller, x0[None], T_steps=int(exp.get("T_steps", 50)), dt=dt,
            observer=observer, generator=generator,
            apply_sequence_substeps=int(exp.get("apply_sequence_substeps", 0)),
        )
        # one lane: the recorder squeezes the batch of one
        rec.record_closed_loop(res)
    elif task == "open_loop":
        out, x_roll = run_open_loop(plant, controller, x0, dt, generator=generator)
        dts = out.info["dts"].detach().cpu().numpy()
        ts = np.concatenate([[0.0], np.cumsum(dts)])
        rec.add_time_series("planned_states", ts, out.x_seq)
        rec.add_time_series("planned_controls", ts[:-1], out.u_seq)
        rec.add_time_series("rollout_states", ts, x_roll)
    elif task == "benchmark_varying_x0":
        bm = exp.get("benchmark", {})
        res, x0s = benchmark_varying_initial_state(
            plant, controller,
            bm.get("x01", [-1.0, 0.0, 1.0]), bm.get("x02", [-1.0, 0.0, 1.0]),
            T_steps=int(exp.get("T_steps", 50)), dt=dt,
            x0_template=x0, generator=generator, device=device, dtype=dtype,
        )
        rec.add_matrix("benchmark/x0_grid", x0s)
        rec.add_matrix("benchmark/final_states", res.x_true[:, -1])
        rec.add_matrix("benchmark/controls", res.u)
    elif task == "benchmark_increasing_n":
        # horizon sweep, one open-loop solve per N
        bm = exp.get("benchmark", {})
        N_values = [int(n) for n in bm.get("N_values", [10, 20, 40])]

        def make_ocp(N):
            cfg_n = dict(config)
            cfg_n["grid"] = dict(config.get("grid", {}), N=N)
            return build_ocp(cfg_n, dtype, device)[0]

        out = benchmark_increasing_n_open_loop(
            make_ocp, N_values, x0, dt_init=dt, device=device, dtype=dtype,
        )
        rec.add_matrix("benchmark/n_values", np.asarray(N_values, dtype=np.float64))
        rec.add_matrix("benchmark/solve_times",
                       np.asarray([r["solve_time_s"] for r in out], dtype=np.float64))
        rec.add_matrix("benchmark/objectives",
                       np.asarray([float(r["objective"]) for r in out], dtype=np.float64))
        rec.add_matrix("benchmark/status",
                       np.asarray([int(r["status"]) for r in out], dtype=np.float64))
    else:
        raise KeyError(f"unknown task {task!r}")
    return rec


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
