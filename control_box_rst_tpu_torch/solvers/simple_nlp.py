"""Generic (non-OCP) NLP interface.

Counterpart of the JAX package's ``solvers/simple_nlp.py``: an NLP defined by
plain callables,

  min  f(z)
  s.t. h(z) = 0,  g(z) ≤ 0,  lb ≤ z ≤ ub,

is lowered to a one-interval stage NLP with z in the control slot (u_0), a
one-dimensional dummy state with zero dynamics, and solved by the port's SQP
(general rows for h and g: the non-fused ADMM). The callables take z
[..., n] and return f [...] and h, g [..., neq] / [..., nineq] (or [...] for
one row), batch-first like every function of the port; z0 may carry leading
dims (a batch of NLPs with the same callables).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from control_box_rst_tpu_torch.models.base import FunctionalDynamics
from control_box_rst_tpu_torch.ocp.constraints import FunctionalStageConstraint
from control_box_rst_tpu_torch.ocp.costs import StageCost
from control_box_rst_tpu_torch.ocp.grids import Grid
from control_box_rst_tpu_torch.ocp.problem import Bounds, Trajectory
from control_box_rst_tpu_torch.ocp.transcribe import transcribe
from control_box_rst_tpu_torch.solvers.sqp import SQPConfig, SQPResult, sqp_solve
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class _FnCost(StageCost):
    fn: Callable = None

    def stage(self, x, u, dt, xref, uref):
        return self.fn(u)


def solve_nlp(
    objective: Callable[[torch.Tensor], torch.Tensor],
    z0: torch.Tensor,
    eq: Optional[Callable] = None,
    neq: int = 0,
    ineq: Optional[Callable] = None,
    nineq: int = 0,
    lb: Optional[torch.Tensor] = None,
    ub: Optional[torch.Tensor] = None,
    cfg: Optional[SQPConfig] = None,
) -> SQPResult:
    """Solve min f(z) s.t. h(z) = 0, g(z) ≤ 0, lb ≤ z ≤ ub from z0, on the
    device and in the dtype of z0. The optimizer: ``nlp_solution(result)``."""
    z0 = torch.as_tensor(z0)
    if z0.dim() == 0:
        z0 = z0[None]
    n, lead = z0.shape[-1], tuple(z0.shape[:-1])
    kw = dict(dtype=z0.dtype, device=z0.device)

    grid = Grid(N=1, kind="fd", fd_scheme="forward", dt_mode="fixed")
    system = FunctionalDynamics(nx=1, nu=n, fn=lambda x, u: torch.zeros_like(x))
    stage_con = None
    if (eq is not None and neq) or (ineq is not None and nineq):
        stage_con = FunctionalStageConstraint(
            neq=neq if eq is not None else 0,
            nineq=nineq if ineq is not None else 0,
            eq_fn=(lambda x, u: eq(u)) if eq is not None else None,
            ineq_fn=(lambda x, u: ineq(u)) if ineq is not None else None,
        )
    bounds = Bounds.unbounded(1, n, **kw)
    if lb is not None or ub is not None:
        bounds = bounds.with_u(
            -torch.inf if lb is None else lb, torch.inf if ub is None else ub)
    ocp = transcribe(
        system, grid, _FnCost(fn=objective), bounds=bounds,
        x0=torch.zeros(lead + (1,), **kw), stage_con=stage_con, **kw,
    )
    traj0 = Trajectory(
        X=torch.zeros(lead + (2, 1), **kw), U=z0[..., None, :],
        dts=torch.ones(lead + (1,), **kw),
    )
    return sqp_solve(ocp, traj0, cfg or SQPConfig())


def nlp_solution(result: SQPResult) -> torch.Tensor:
    """The optimizer z* [..., n] of a ``solve_nlp`` result."""
    return result.traj.U[..., 0, :]
