"""Stage-structured OCP data model.

Counterpart of the JAX package's ``ocp/problem.py``: the decision variables
are three dense arrays (states X, controls U, time steps dts), fixing is a
mask, bounds are arrays. Every array may carry leading batch dims.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class Trajectory:
    """Decision variables of a transcribed OCP.

    X:   [..., N+1, nx] state sequence (x_0 .. x_N)
    U:   [..., N,   nu] control sequence (u_0 .. u_{N-1})
    dts: [..., N]       per-interval time steps.

    The three arrays need not carry the same leading dims: an initial guess
    that shares U and dts between lanes keeps them unbatched, and
    ``TranscribedOCP.pack`` broadcasts.
    """

    X: torch.Tensor
    U: torch.Tensor
    dts: torch.Tensor

    @property
    def N(self) -> int:
        return self.U.shape[-2]

    @property
    def nx(self) -> int:
        return self.X.shape[-1]

    @property
    def nu(self) -> int:
        return self.U.shape[-1]

    def total_time(self) -> torch.Tensor:
        return self.dts.sum(dim=-1)

    @staticmethod
    def linear_interp(
        x0: torch.Tensor, xf: torch.Tensor, N: int, nu: int, dt: float
    ) -> "Trajectory":
        """States on the line x0 → xf, controls zero, uniform dt.

        x0, xf: [..., nx]. X takes their leading dims; U [N, nu] and dts [N]
        are the same for every lane and stay unbatched."""
        alphas = torch.linspace(
            0.0, 1.0, N + 1, dtype=x0.dtype, device=x0.device
        )[:, None]
        X = x0[..., None, :] * (1.0 - alphas) + xf[..., None, :] * alphas
        U = torch.zeros((N, nu), dtype=X.dtype, device=X.device)
        dts = torch.full((N,), dt, dtype=X.dtype, device=X.device)
        return Trajectory(X=X, U=U, dts=dts)


@plain_dataclass
class Bounds:
    """Box bounds on states, controls, and time steps. ±inf = unbounded."""

    x_lb: torch.Tensor  # [nx]
    x_ub: torch.Tensor
    u_lb: torch.Tensor  # [nu]
    u_ub: torch.Tensor
    dt_lb: torch.Tensor  # scalar
    dt_ub: torch.Tensor

    @staticmethod
    def unbounded(nx: int, nu: int, dtype=None, device=None) -> "Bounds":
        """``dtype=None`` means float32, ``device=None`` the card."""
        kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
        return Bounds(
            x_lb=torch.full((nx,), -math.inf, **kw),
            x_ub=torch.full((nx,), math.inf, **kw),
            u_lb=torch.full((nu,), -math.inf, **kw),
            u_ub=torch.full((nu,), math.inf, **kw),
            dt_lb=torch.tensor(0.0, **kw),
            dt_ub=torch.tensor(math.inf, **kw),
        )

    def _like(self, v, ref):
        return torch.as_tensor(v, dtype=ref.dtype, device=ref.device).expand(ref.shape).clone()

    def with_u(self, u_lb, u_ub) -> "Bounds":
        return self.replace(u_lb=self._like(u_lb, self.u_lb), u_ub=self._like(u_ub, self.u_ub))

    def with_x(self, x_lb, x_ub) -> "Bounds":
        return self.replace(x_lb=self._like(x_lb, self.x_lb), x_ub=self._like(x_ub, self.x_ub))

    def with_dt(self, dt_lb, dt_ub) -> "Bounds":
        return self.replace(dt_lb=self._like(dt_lb, self.dt_lb), dt_ub=self._like(dt_ub, self.dt_ub))


@plain_dataclass
class References:
    """Stage reference trajectories for tracking costs.
    xref: [N+1, nx], uref: [N, nu]."""

    xref: torch.Tensor
    uref: torch.Tensor

    @staticmethod
    def constant(xref: torch.Tensor, uref: torch.Tensor, N: int) -> "References":
        return References(
            xref=xref.expand((N + 1,) + tuple(xref.shape)).clone(),
            uref=uref.expand((N,) + tuple(uref.shape)).clone(),
        )


@plain_dataclass
class BoundaryConditions:
    """Initial state and terminal handling.

    x0:       [..., nx] fixed initial state (one per lane when batched).
    xf:       [nx] terminal reference for terminal pins.
    xf_fixed: [nx] mask — which terminal components are pinned to xf.
    """

    x0: torch.Tensor
    xf: Optional[torch.Tensor] = None
    xf_fixed: Optional[torch.Tensor] = None
