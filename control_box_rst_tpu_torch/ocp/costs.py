"""Stage and terminal cost functions.

Counterpart of the JAX package's ``ocp/costs.py``: a cost is a frozen
dataclass with a pure ``stage(x, u, dt, xref, uref) -> [...]`` (and
``final(x, xref)`` for terminal terms). Operands broadcast over leading dims
(x [..., nx], u [..., nu], dt [...]), so one call evaluates every stage of
every lane. ``integral=True`` costs are quadrature-weighted by the
transcription; non-integral costs are summed per stage.

The least-squares form for the Gauss-Newton / Levenberg-Marquardt solver is
``stage_residual`` / ``final_residual``: r with cost = rᵀr, [..., n_r]. The
matrix square roots it needs are taken once, when the cost object is built
(on the host, in float64), not per evaluation.

``riccati_terminal_cost`` takes Qf from the algebraic Riccati equation
(``ops/matrix_eq.py``) at the linearization, once, when it is built.
"""
from __future__ import annotations

import math

import torch

from control_box_rst_tpu_torch.ops.smallmat import mv_small
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


def _quad(d: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """dᵀ M d over the last dim, broadcast-multiply-sum."""
    return (d[..., :, None] * M * d[..., None, :]).sum(dim=(-2, -1))


def _sqrtm_psd(M: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD matrix square root via eigh (small matrices), computed
    on the host in float64 and returned as ``M``'s dtype on ``M``'s device."""
    w, V = torch.linalg.eigh(M.detach().to(device="cpu", dtype=torch.float64))
    root = (V * torch.sqrt(torch.clamp(w, min=0.0))[None, :]) @ V.T
    return root.to(device=M.device, dtype=M.dtype)


def _set_sqrt(obj, **matrices) -> None:
    """Keep the square roots of a frozen cost object's weights beside them
    (plain attributes, not dataclass fields: a copy on another device or in
    another dtype takes them anew from its own weights)."""
    for name, M in matrices.items():
        object.__setattr__(obj, name, None if M is None else _sqrtm_psd(M))


@plain_dataclass
class StageCost:
    """Base: zero cost. Subclasses override stage()/final()."""

    integral: bool = False
    lsq_form: bool = False
    # whether the stage Hessian is PSD everywhere
    convex: bool = True
    # whether stage()/final() are (at most) quadratic in (x, u) for fixed dt;
    # solvers hoist the constant cost Hessian on LTI problems then
    quadratic: bool = False

    def stage(self, x, u, dt, xref, uref):
        return torch.zeros_like(x[..., 0])

    def final(self, x, xref):
        return torch.zeros_like(x[..., 0])

    def stage_residual(self, x, u, dt, xref, uref):
        """LSQ residual r [..., n_r] with cost = r'r. Default: none (empty)."""
        return (x - xref)[..., :0]

    def final_residual(self, x, xref):
        """LSQ residual of the terminal cost, final = r'r. Default: none."""
        return (x - xref)[..., :0]


@plain_dataclass
class QuadraticFormCost(StageCost):
    """(x-xref)'Q(x-xref) + (u-uref)'R(u-uref)."""

    quadratic: bool = True
    Q: torch.Tensor = None  # [nx, nx]
    R: torch.Tensor = None  # [nu, nu]

    def __post_init__(self):
        _set_sqrt(self, _Qs=self.Q, _Rs=self.R)

    def stage(self, x, u, dt, xref, uref):
        return _quad(x - xref, self.Q) + _quad(u - uref, self.R)

    def stage_residual(self, x, u, dt, xref, uref):
        # sqrt-weighted residual; assumes Q, R PSD
        return torch.cat(
            [mv_small(self._Qs, x - xref), mv_small(self._Rs, u - uref)], dim=-1)


@plain_dataclass
class QuadraticFinalStateCost(StageCost):
    """Terminal cost (x_N - xref)'Qf(x_N - xref)."""

    quadratic: bool = True
    Qf: torch.Tensor = None

    def __post_init__(self):
        _set_sqrt(self, _Qfs=self.Qf)

    def final(self, x, xref):
        return _quad(x - xref, self.Qf)

    def final_residual(self, x, xref):
        return mv_small(self._Qfs, x - xref)


@plain_dataclass
class QuadraticStateCost(StageCost):
    """(x-xref)'Q(x-xref)."""

    quadratic: bool = True
    Q: torch.Tensor = None

    def __post_init__(self):
        _set_sqrt(self, _Qs=self.Q)

    def stage(self, x, u, dt, xref, uref):
        return _quad(x - xref, self.Q)

    def stage_residual(self, x, u, dt, xref, uref):
        return mv_small(self._Qs, x - xref)


@plain_dataclass
class QuadraticControlCost(StageCost):
    """(u-uref)'R(u-uref)."""

    quadratic: bool = True
    R: torch.Tensor = None

    def __post_init__(self):
        _set_sqrt(self, _Rs=self.R)

    def stage(self, x, u, dt, xref, uref):
        return _quad(u - uref, self.R)

    def stage_residual(self, x, u, dt, xref, uref):
        return mv_small(self._Rs, u - uref)


@plain_dataclass
class MinimumTime(StageCost):
    """Time-optimal objective: total time Σ dt_k (weight 1 per interval).

    ``lsq_form=True`` follows the reference's least-squares mode: the
    per-interval residual is √weight·dt_k, so the objective becomes
    weight·Σ dt_k² — the same optimum on a grid with one tied dt, a
    different one where every dt_k is free. ``stage()`` returns that same
    value, so SQP and LM optimize one objective. The weight is not scaled
    with the number of intervals (as in the reference)."""

    weight: float = 1.0

    def stage(self, x, u, dt, xref, uref):
        if self.lsq_form:
            return self.weight * dt * dt
        return self.weight * dt

    def stage_residual(self, x, u, dt, xref, uref):
        if self.lsq_form:
            return math.sqrt(self.weight) * dt[..., None]
        return super().stage_residual(x, u, dt, xref, uref)


@plain_dataclass
class MinimumTimeRegularized(StageCost):
    """w·Σdt + reg·Σdt²."""

    weight: float = 1.0
    reg: float = 1e-3

    def stage(self, x, u, dt, xref, uref):
        return self.weight * dt + self.reg * dt * dt


@plain_dataclass
class MinTimeQuadratic(StageCost):
    """Blend: time_weight·Σdt + a quadratic tracking term (Q and R each
    optional)."""

    time_weight: float = 1.0
    Q: torch.Tensor = None
    R: torch.Tensor = None

    def stage(self, x, u, dt, xref, uref):
        c = self.time_weight * dt
        if self.Q is not None:
            c = c + _quad(x - xref, self.Q)
        if self.R is not None:
            c = c + _quad(u - uref, self.R)
        return c


def MinTimeQuadraticControls(time_weight=1.0, R=None) -> MinTimeQuadratic:
    """Time + control effort: ``MinTimeQuadratic`` without the state term."""
    return MinTimeQuadratic(time_weight=time_weight, Q=None, R=R)


def MinTimeQuadraticStates(time_weight=1.0, Q=None) -> MinTimeQuadratic:
    """Time + state tracking: ``MinTimeQuadratic`` without the control term."""
    return MinTimeQuadratic(time_weight=time_weight, Q=Q, R=None)


@plain_dataclass
class MinTimeQuadraticGainScheduled(StageCost):
    """Gain-scheduled blend: the quadratic weights fade in as ‖x − xref‖
    shrinks below ``radius``, through a sigmoid of the squared distance
    (smooth everywhere, unlike the distance itself). Not convex: solvers
    clamp its Hessian blocks to PSD."""

    time_weight: float = 1.0
    Q: torch.Tensor = None
    R: torch.Tensor = None
    radius: float = 1.0
    sharpness: float = 10.0
    convex: bool = False

    def stage(self, x, u, dt, xref, uref):
        dx = x - xref
        gain = torch.sigmoid(
            self.sharpness * (1.0 - (dx * dx).sum(dim=-1) / (self.radius ** 2)))
        c = self.time_weight * dt
        if self.Q is not None:
            c = c + gain * _quad(dx, self.Q)
        if self.R is not None and uref is not None:
            c = c + gain * _quad(u - uref, self.R)
        return c


def riccati_terminal_cost(system, xref, uref, Q, R, dt=None):
    """Qf from the algebraic Riccati equation at the linearization
    (xref [nx], uref [nu]): the CARE of a continuous-time system, the DARE of
    a discrete one — the stabilizing cost-to-go, which makes the
    finite-horizon cost a quasi-infinite-horizon one. Returns a
    ``QuadraticFinalStateCost`` in the dtype and on the device of ``xref``
    (``dt`` is accepted and, as in the reference, not used)."""
    from control_box_rst_tpu_torch.ops.matrix_eq import solve_care, solve_dare

    xref = torch.as_tensor(xref)
    uref = torch.as_tensor(uref, dtype=xref.dtype, device=xref.device)
    A = system.linear_A(xref, uref)
    B = system.linear_B(xref, uref)
    solve = solve_care if system.continuous_time else solve_dare
    return QuadraticFinalStateCost(Qf=solve(A, B, Q, R))


@plain_dataclass
class L1SoftConstraintCost(StageCost):
    """Exact-penalty (L1) soft constraints as a cost term: a stage
    constraint's violations enter the objective as weight·‖·‖₁ — inequality
    rows weight·max(0, g), equality rows weight·|h|."""

    constraint: object = None  # a StageConstraint
    weight: float = 1.0

    def stage(self, x, u, dt, xref, uref):
        c = self.constraint
        total = torch.zeros_like(x[..., 0])
        if c.nineq:
            g = c.ineq(x, u, dt, xref, uref)
            total = total + self.weight * torch.maximum(torch.zeros_like(g), g).sum(dim=-1)
        if c.neq:
            h = c.eq(x, u, dt, xref, uref)
            total = total + self.weight * h.abs().sum(dim=-1)
        return total


@plain_dataclass
class CompositeCost(StageCost):
    """Sum of a stage cost and a terminal cost object (or several)."""

    costs: tuple = ()

    def __post_init__(self):
        object.__setattr__(
            self, "convex", all(getattr(c, "convex", True) for c in self.costs)
        )
        object.__setattr__(
            self, "quadratic",
            all(getattr(c, "quadratic", False) for c in self.costs),
        )

    def stage(self, x, u, dt, xref, uref):
        total = torch.zeros_like(x[..., 0])
        for c in self.costs:
            total = total + c.stage(x, u, dt, xref, uref)
        return total

    def final(self, x, xref):
        total = torch.zeros_like(x[..., 0])
        for c in self.costs:
            total = total + c.final(x, xref)
        return total

    def stage_residual(self, x, u, dt, xref, uref):
        parts = [c.stage_residual(x, u, dt, xref, uref) for c in self.costs]
        return torch.cat(parts, dim=-1) if parts else (x - xref)[..., :0]

    def final_residual(self, x, xref):
        parts = [c.final_residual(x, xref) for c in self.costs]
        return torch.cat(parts, dim=-1) if parts else (x - xref)[..., :0]
