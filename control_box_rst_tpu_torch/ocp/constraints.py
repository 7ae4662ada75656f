"""Stage and terminal constraint functions.

Counterpart of the JAX package's ``ocp/constraints.py``. Convention:
inequality rows are g(·) ≤ 0 (elementwise), equality rows h(·) = 0, and
their counts ``neq`` / ``nineq`` are fixed when the object is built, so the
transcription's general rows have a fixed width ng. Box bounds do not live
here: they are first-class in ``ocp/problem.py:Bounds``.

Operands broadcast over leading dims, as the costs' do: x [..., nx],
u [..., nu], dt [...], and every function returns its rows as [..., n].
A user callable may return [...] for a single row; ``as_rows`` adds the
trailing dim (the batch-first form of the reference's ``atleast_1d``).
Callables that keep trailing dims (``x[..., 1:2]``) are the safer form:
forward-mode AD of a 0-dim slice combined with a Python number has been seen
to return float64 tangents for float32 inputs.
"""
from __future__ import annotations

from typing import Callable

import torch

from control_box_rst_tpu_torch.ops.smallmat import mv_small
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


def as_rows(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as rows [..., n]: a value with the leading dims of ``like`` and
    no trailing dim becomes one row."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v, device=like.device)
    v = v.to(like.dtype)
    return v[..., None] if v.dim() < like.dim() else v


def no_rows(like: torch.Tensor) -> torch.Tensor:
    """[..., 0]: the rows of a constraint that has none."""
    return like[..., :0]


@plain_dataclass
class StageConstraint:
    """Base: no constraints. Subclasses override and set the row counts."""

    neq: int = 0
    nineq: int = 0

    def eq(self, x, u, dt, xref, uref):
        return no_rows(x)

    def ineq(self, x, u, dt, xref, uref):
        return no_rows(x)


@plain_dataclass
class FunctionalStageConstraint(StageConstraint):
    """User callables g(x, u) ≤ 0 / h(x, u) = 0 on batch-first tensors."""

    eq_fn: Callable = None
    ineq_fn: Callable = None

    def eq(self, x, u, dt, xref, uref):
        if self.eq_fn is None:
            return no_rows(x)
        return as_rows(self.eq_fn(x, u), x)

    def ineq(self, x, u, dt, xref, uref):
        if self.ineq_fn is None:
            return no_rows(x)
        return as_rows(self.ineq_fn(x, u), x)


@plain_dataclass
class TerminalConstraint:
    """Base terminal constraint: h(x_N) = 0 (neq) and g(x_N) ≤ 0 (nineq)."""

    neq: int = 0
    nineq: int = 0

    def eq(self, x, xref):
        return no_rows(x)

    def ineq(self, x, xref):
        return no_rows(x)


@plain_dataclass
class TerminalBall(TerminalConstraint):
    """Terminal region ‖x_N − xref‖²_S ≤ γ  →  g = dxᵀ S dx − γ ≤ 0."""

    nineq: int = 1
    S: torch.Tensor = None
    gamma: float = 1.0

    def ineq(self, x, xref):
        dx = x - xref
        return ((dx * mv_small(self.S, dx)).sum(dim=-1) - self.gamma)[..., None]


def terminal_ball_from_cost(final_cost, gamma) -> TerminalBall:
    """The terminal ball with S = Qf of a terminal cost."""
    return TerminalBall(S=final_cost.Qf, gamma=gamma)


@plain_dataclass
class TerminalEquality(TerminalConstraint):
    """x_N = xref exactly (``neq`` = nx). Pinning x_N through
    ``BoundaryConditions.xf_fixed`` needs no rows; this is the same
    constraint as general equality rows."""

    def eq(self, x, xref):
        return x - xref


def terminal_equality(nx: int) -> TerminalEquality:
    return TerminalEquality(neq=nx)


@plain_dataclass
class TerminalPartialEquality(TerminalConstraint):
    """Selected components of x_N pinned to xref (``mask``: their indices)."""

    mask: tuple = ()

    def eq(self, x, xref):
        idx = list(self.mask)
        return x[..., idx] - xref[..., idx]


def terminal_partial_equality(indices) -> TerminalPartialEquality:
    indices = tuple(int(i) for i in indices)
    return TerminalPartialEquality(neq=len(indices), mask=indices)
