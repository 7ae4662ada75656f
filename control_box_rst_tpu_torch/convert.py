"""State carried across: build the port's objects from numpy arrays.

The JAX package and the port share no code and no objects. What crosses
between them — in the comparison tests, or when a problem set up elsewhere is
handed to the port — is a dict of numpy arrays and static fields (the form
``np.asarray`` extracts from the JAX objects). This module imports no JAX.

``ocp_from_numpy(spec)`` keys (arrays are numpy, anything array-like works):

  static:  N, nx, nu, system (any registered system name, with its
           parameters under their field names: see ``system_from_numpy``),
           grid_kind ("fd" | "ms"),
           fd_scheme ("forward" | "backward" | "midpoint" | "crank_nicolson"
           | "hermite_simpson" | "hermite_simpson_lc" |
           "hermite_simpson_unc"), integrator ("euler", "rk2" … "rk7"),
           integrator_substeps, cost_integration, dt_mode ("fixed" |
           "single" | "per_interval"), u_blocks (move blocking: a block id
           per interval, or None),
           cost ("quadratic" | "minimum_time"),
           cost_integral, lsq_form
  cost:    "quadratic": Q [nx,nx], R [nu,nu], Qf [nx,nx] (Qf optional);
           "minimum_time": weight
  bounds:  x_lb, x_ub [nx], u_lb, u_ub [nu], dt_lb, dt_ub scalars
  refs:    xref [N+1,nx], uref [N,nu]
  bc:      x0 [..., nx], xf [nx] or None, xf_fixed [nx] or None
  mask:    stage_mask [N], or [..., N] for one active horizon per lane
  general rows (optional): stage_con, term_con — constraint specs
  any cost: cost_spec — a cost spec, in place of the ``cost`` keys above

A cost or constraint spec (``cost_from_numpy``, ``constraint_from_numpy``)
is a dict with ``kind``, the class name (the same in both packages), and any
of the class's fields: arrays (``Q``, ``R``, ``Qf``, ``S``), numbers
(``weight``, ``gamma``, ``neq``, ``nineq`` …), index tuples (``mask``),
nested specs (``costs`` of a ``CompositeCost``, ``constraint`` of an
``L1SoftConstraintCost``) and, for the functional and preprocessed classes,
the port's own callables.

``mpc_carry_from_numpy`` takes the fields of an ``MPCCarry`` (W, y_dyn,
y_gen, y_box, u_prev, n_active, feas_prev), so that both packages can be
handed the same mid-rollout carry. ``adaptation_from_numpy`` builds a grid
adaptation from the class name of the reference's (``kind``) and its fields.

The LQR family: ``lqr_from_numpy`` (K, xref, uref), ``pid_from_numpy`` (the
gains, xref) with ``pid_carry_from_numpy`` (p_error, i_error),
``dual_mode_carry_from_numpy`` (mpc_carry — an MPCCarry's fields —,
local_carry, local_active) and ``kalman_from_numpy`` (Ad, Bd, C, L).
``stage_matrix_from_numpy`` packs a trajectory (X, U, dts) into an OCP's
stage matrix W with the midpoint slots of the uncompressed Hermite-Simpson
grid (Xm) when it has them; a move-blocking grid comes with ``u_blocks``.

Every function here takes ``dtype`` (``None`` means float32) and ``device``
(``None`` means the card, and raises when there is none; the CPU has to be
asked for with ``device="cpu"``).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import dataclasses

import numpy as np
import torch

from control_box_rst_tpu_torch.control.classic import LqrController, PidCarry, PidController
from control_box_rst_tpu_torch.control.dual_mode import DualModeCarry
from control_box_rst_tpu_torch.control.predictive import MPCCarry
from control_box_rst_tpu_torch.sim.observer import KalmanCarry, SteadyStateKalmanObserver
from control_box_rst_tpu_torch.ocp import adaptation as _adaptation
from control_box_rst_tpu_torch.ocp import constraints as _constraints
from control_box_rst_tpu_torch.ocp import costs as _costs
from control_box_rst_tpu_torch.ocp import preprocessor as _preprocessor
from control_box_rst_tpu_torch.core.factory import Factory
from control_box_rst_tpu_torch.models.benchmark import LinearStateSpaceModel
from control_box_rst_tpu_torch.ocp.costs import (
    CompositeCost,
    MinimumTime,
    QuadraticFinalStateCost,
    QuadraticFormCost,
)
from control_box_rst_tpu_torch.ocp.grids import Grid
from control_box_rst_tpu_torch.ocp.problem import (
    BoundaryConditions,
    Bounds,
    References,
    Trajectory,
)
from control_box_rst_tpu_torch.ocp.transcribe import TranscribedOCP
from control_box_rst_tpu_torch.solvers.sqp import SQPWarmStart
from control_box_rst_tpu_torch.solvers.stage_qp import QPWarmStart, StageQP
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype


def _tensor(a, dtype, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(
        np.array(a), device=resolve_device(device)).to(resolve_dtype(dtype))


def system_from_numpy(spec: Mapping[str, Any], dtype=None, device=None):
    """One of the twelve registered systems: ``system`` names it (default
    "serial_integrators"), ``nx``/``nu`` its dims, and any of its parameter
    fields (``time_constant``, ``a``, ``damping``, ``spring_alpha``,
    ``spring_beta``, ``m``, ``l``, ``g``, ``rho``, ``omega0``, ``mc``,
    ``mp``, ``mu``, ``dt``) their values; fields left out keep their
    defaults. Scalars stay numbers; "linear_state_space" takes ``A`` and
    ``B`` (rounded to float32 as the reference's ``from_matrices`` rounds
    them, then cast to ``dtype`` on ``device``)."""
    import control_box_rst_tpu_torch.models.benchmark  # noqa: F401 (registers)

    name = spec.get("system", "serial_integrators")
    if name == "linear_state_space":
        sys_ = LinearStateSpaceModel.from_matrices(spec["A"], spec["B"])
        return sys_.replace(A=_tensor(sys_.A, dtype, device), B=_tensor(sys_.B, dtype, device))
    cls = Factory.get("system", name)
    params = {}
    for f in dataclasses.fields(cls):
        if f.name in ("nx", "nu", "continuous_time") or spec.get(f.name) is None:
            continue
        a = np.asarray(spec[f.name])
        params[f.name] = float(a) if a.ndim == 0 else _tensor(a, dtype, device)
    return cls(nx=int(spec["nx"]), nu=int(spec["nu"]), **params)


def ocp_from_numpy(spec: Mapping[str, Any], dtype=None,
                   device=None) -> TranscribedOCP:
    t = lambda key: _tensor(spec.get(key), dtype, device)
    system = system_from_numpy(spec, dtype, device)
    grid = Grid(
        N=int(spec["N"]), kind=spec.get("grid_kind", "fd"),
        fd_scheme=spec.get("fd_scheme", "crank_nicolson"),
        integrator=spec.get("integrator", "rk4"),
        integrator_substeps=int(spec.get("integrator_substeps", 1)),
        cost_integration=spec.get("cost_integration", "left_sum"),
        dt_mode=spec.get("dt_mode", "fixed"),
        u_blocks=(None if spec.get("u_blocks") is None
                  else tuple(int(b) for b in spec["u_blocks"])),
    )
    integral = bool(spec.get("cost_integral", False))
    lsq_form = bool(spec.get("lsq_form", False))
    cost_name = spec.get("cost", "quadratic")
    if spec.get("cost_spec") is not None:
        cost = cost_from_numpy(spec["cost_spec"], dtype, device)
    elif cost_name == "minimum_time":
        cost = MinimumTime(weight=float(spec.get("weight", 1.0)),
                           integral=integral, lsq_form=lsq_form)
    elif cost_name == "quadratic":
        costs = [QuadraticFormCost(
            Q=t("Q"), R=t("R"), integral=integral, lsq_form=lsq_form)]
        if spec.get("Qf") is not None:
            costs.append(QuadraticFinalStateCost(Qf=t("Qf")))
        cost = CompositeCost(costs=tuple(costs), integral=integral)
    else:
        raise NotImplementedError(f"cost {cost_name!r} is not ported yet")
    bounds = Bounds(
        x_lb=t("x_lb"), x_ub=t("x_ub"), u_lb=t("u_lb"), u_ub=t("u_ub"),
        dt_lb=t("dt_lb"), dt_ub=t("dt_ub"),
    )
    con = lambda key: (None if spec.get(key) is None
                       else constraint_from_numpy(spec[key], dtype, device))
    return TranscribedOCP(
        grid=grid, system=system, cost=cost, bounds=bounds,
        stage_con=con("stage_con"), term_con=con("term_con"),
        bc=BoundaryConditions(x0=t("x0"), xf=t("xf"), xf_fixed=t("xf_fixed")),
        refs=References(xref=t("xref"), uref=t("uref")),
        stage_mask=t("stage_mask"),
    )


def trajectory_from_numpy(d: Mapping[str, Any], dtype=None,
                          device=None) -> Trajectory:
    return Trajectory(**{k: _tensor(d[k], dtype, device) for k in ("X", "U", "dts")})


def stage_qp_from_numpy(d: Mapping[str, Any], dtype=None,
                        device=None) -> StageQP:
    keys = ("Hd", "g", "J", "K", "c", "G", "gl", "gu", "dlb", "dub")
    return StageQP(**{k: _tensor(d[k], dtype, device) for k in keys})


def qp_warm_start_from_numpy(d: Mapping[str, Any], dtype=None,
                             device=None) -> QPWarmStart:
    keys = ("delta", "y_dyn", "y_gen", "y_box")
    return QPWarmStart(*(_tensor(d[k], dtype, device) for k in keys))


def sqp_warm_start_from_numpy(d: Mapping[str, Any], dtype=None,
                              device=None) -> SQPWarmStart:
    keys = ("W", "y_dyn", "y_gen", "y_box")
    return SQPWarmStart(*(_tensor(d[k], dtype, device) for k in keys))


def mpc_carry_from_numpy(d: Mapping[str, Any], dtype=None,
                         device=None) -> MPCCarry:
    """An ``MPCCarry`` from numpy arrays (a carry of the JAX package, batched
    or not); ``n_active`` becomes int32, the rest ``dtype``."""
    floats = {k: _tensor(d[k], dtype, device)
              for k in ("W", "y_dyn", "y_gen", "y_box", "u_prev", "feas_prev")}
    n_active = torch.as_tensor(
        np.array(d["n_active"]), device=resolve_device(device)).to(torch.int32)
    return MPCCarry(n_active=n_active, **floats)


_ADAPTATIONS = {
    cls.__name__: cls for cls in (
        _adaptation.GridAdaptation, _adaptation.TimeBasedSingleStep,
        _adaptation.TimeBasedAggressiveEstimate, _adaptation.SimpleShrinkingHorizon,
        _adaptation.GrowOnInfeasibility, _adaptation.RedundantControls,
    )
}


def adaptation_from_numpy(d: Mapping[str, Any]) -> _adaptation.GridAdaptation:
    """A grid adaptation from ``kind`` (the class name, the same in both
    packages) and any of its fields (``n_min``, ``n_max``, ``dt_ref``,
    ``dt_hyst_ratio``, ``feas_tol``, ``epsilon``, ``backup``) as numbers or
    0-d arrays; fields left out keep their defaults. Holds no tensor, so it
    takes no device or dtype."""
    kind = d["kind"]
    if kind not in _ADAPTATIONS:
        raise KeyError(f"unknown grid adaptation {kind!r}; have {sorted(_ADAPTATIONS)}")
    cls = _ADAPTATIONS[kind]
    return cls(**{f.name: type(f.default)(np.asarray(d[f.name]).item())
                  for f in dataclasses.fields(cls) if f.name in d})


_COSTS = {cls.__name__: cls for cls in (
    _costs.StageCost, _costs.QuadraticFormCost, _costs.QuadraticFinalStateCost,
    _costs.QuadraticStateCost, _costs.QuadraticControlCost, _costs.MinimumTime,
    _costs.MinimumTimeRegularized, _costs.MinTimeQuadratic,
    _costs.MinTimeQuadraticGainScheduled, _costs.L1SoftConstraintCost,
    _costs.CompositeCost, _preprocessor.PreprocessedStageCost,
)}
_CONSTRAINTS = {cls.__name__: cls for cls in (
    _constraints.StageConstraint, _constraints.FunctionalStageConstraint,
    _constraints.TerminalConstraint, _constraints.TerminalBall,
    _constraints.TerminalEquality, _constraints.TerminalPartialEquality,
    _preprocessor.PreprocessedStageConstraint,
)}


def _fields_from_numpy(cls, d: Mapping[str, Any], dtype, device) -> dict:
    """The fields of ``cls`` that ``d`` names: arrays of one dim or more
    become tensors, 0-d arrays numbers, tuples and lists of numbers index
    tuples, nested specs objects; anything else (callables, flags) is taken
    as it is."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.name not in d or d[f.name] is None:
            continue
        v = d[f.name]
        if f.name == "costs":
            v = tuple(cost_from_numpy(c, dtype, device) for c in v)
        elif f.name == "constraint":
            v = constraint_from_numpy(v, dtype, device)
        elif isinstance(v, (list, tuple)):
            v = tuple(int(i) for i in v)
        elif isinstance(v, np.ndarray) or hasattr(v, "__array__"):
            a = np.asarray(v)
            v = _tensor(a, dtype, device) if a.ndim else a.item()
        out[f.name] = v
    return out


def cost_from_numpy(d: Mapping[str, Any], dtype=None, device=None) -> _costs.StageCost:
    """A stage cost from ``kind`` (the class name) and its fields."""
    kind = d["kind"]
    if kind not in _COSTS:
        raise KeyError(f"unknown cost {kind!r}; have {sorted(_COSTS)}")
    cls = _COSTS[kind]
    return cls(**_fields_from_numpy(cls, d, dtype, device))


def constraint_from_numpy(d: Mapping[str, Any], dtype=None, device=None):
    """A stage or terminal constraint from ``kind`` (the class name) and its
    fields (``TerminalBall``: S, gamma; ``TerminalEquality``: neq;
    ``TerminalPartialEquality``: mask, neq; the functional class: its
    callables and row counts)."""
    kind = d["kind"]
    if kind not in _CONSTRAINTS:
        raise KeyError(f"unknown constraint {kind!r}; have {sorted(_CONSTRAINTS)}")
    cls = _CONSTRAINTS[kind]
    return cls(**_fields_from_numpy(cls, d, dtype, device))


def stage_matrix_from_numpy(ocp: TranscribedOCP, d: Mapping[str, Any], dtype=None,
                            device=None) -> torch.Tensor:
    """The stage matrix W [..., N+1, nz] of ``ocp`` for the trajectory X, U,
    dts of ``d``; on the uncompressed Hermite-Simpson grid the midpoint slots
    take ``d["Xm"]`` [..., N+1, nx] (stage N's slot included) where given,
    else ``pack``'s linear midpoints."""
    W = ocp.pack(trajectory_from_numpy(d, dtype, device))
    if ocp.n_aux and d.get("Xm") is not None:
        W = W.clone()
        W[..., ocp.nx + ocp.nu + 1:] = _tensor(d["Xm"], dtype, device)
    return W


def lqr_from_numpy(d: Mapping[str, Any], dtype=None, device=None) -> LqrController:
    """An ``LqrController`` from its gain K [nu, nx] and xref, uref."""
    K = _tensor(d["K"], dtype, device)
    return LqrController(nx=K.shape[1], nu=K.shape[0], K=K,
                         xref=_tensor(d["xref"], dtype, device),
                         uref=_tensor(d["uref"], dtype, device))


def pid_from_numpy(d: Mapping[str, Any], dtype=None, device=None) -> PidController:
    """A ``PidController`` from nx, nu, its gains (numbers or arrays) and
    xref (or None)."""
    gain = lambda k: (float(np.asarray(d.get(k, 0.0))) if np.ndim(d.get(k, 0.0)) == 0
                      else _tensor(d[k], dtype, device))
    return PidController(nx=int(d["nx"]), nu=int(d["nu"]), p_gain=gain("p_gain"),
                         i_gain=gain("i_gain"), d_gain=gain("d_gain"),
                         xref=_tensor(d.get("xref"), dtype, device))


def pid_carry_from_numpy(d: Mapping[str, Any], dtype=None, device=None) -> PidCarry:
    return PidCarry(p_error=_tensor(d["p_error"], dtype, device),
                    i_error=_tensor(d["i_error"], dtype, device))


def dual_mode_carry_from_numpy(d: Mapping[str, Any], dtype=None,
                               device=None) -> DualModeCarry:
    """A ``DualModeCarry``: ``mpc_carry`` the fields of an ``MPCCarry``,
    ``local_carry`` those of a ``PidCarry`` or None (an LQR carries
    nothing), ``local_active`` bool [B]."""
    local = d.get("local_carry")
    return DualModeCarry(
        mpc_carry=mpc_carry_from_numpy(d["mpc_carry"], dtype, device),
        local_carry=() if not local else pid_carry_from_numpy(local, dtype, device),
        local_active=torch.as_tensor(np.array(d["local_active"]),
                                     device=resolve_device(device)).to(torch.bool),
    )


def kalman_from_numpy(d: Mapping[str, Any], dtype=None,
                      device=None) -> SteadyStateKalmanObserver:
    """A ``SteadyStateKalmanObserver`` from Ad, Bd, C and its gain L."""
    return SteadyStateKalmanObserver(**{k: _tensor(d[k], dtype, device)
                                        for k in ("Ad", "Bd", "C", "L")})


def kalman_carry_from_numpy(d: Mapping[str, Any], dtype=None, device=None) -> KalmanCarry:
    return KalmanCarry(x_hat=_tensor(d["x_hat"], dtype, device))
