"""Stage and terminal cost functions.

Counterpart of the JAX package's ``ocp/costs.py``: a cost is a frozen
dataclass with a pure ``stage(x, u, dt, xref, uref) -> [...]`` (and
``final(x, xref)`` for terminal terms). Operands broadcast over leading dims
(x [..., nx], u [..., nu], dt [...]), so one call evaluates every stage of
every lane. ``integral=True`` costs are quadrature-weighted by the
transcription; non-integral costs are summed per stage.

This slice carries the quadratic tracking costs of config 1.
"""
from __future__ import annotations

import torch

from control_box_rst_tpu_torch.utils.tree import plain_dataclass


def _quad(d: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """dᵀ M d over the last dim, broadcast-multiply-sum."""
    return (d[..., :, None] * M * d[..., None, :]).sum(dim=(-2, -1))


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


@plain_dataclass
class QuadraticFormCost(StageCost):
    """(x-xref)'Q(x-xref) + (u-uref)'R(u-uref)."""

    quadratic: bool = True
    Q: torch.Tensor = None  # [nx, nx]
    R: torch.Tensor = None  # [nu, nu]

    def stage(self, x, u, dt, xref, uref):
        return _quad(x - xref, self.Q) + _quad(u - uref, self.R)


@plain_dataclass
class QuadraticFinalStateCost(StageCost):
    """Terminal cost (x_N - xref)'Qf(x_N - xref)."""

    quadratic: bool = True
    Qf: torch.Tensor = None

    def final(self, x, xref):
        return _quad(x - xref, self.Qf)


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
