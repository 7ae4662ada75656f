"""Discretization grids.

Counterpart of the JAX package's ``ocp/grids.py``: a grid is a static
description of how the trajectory arrays parameterize the NLP. All variants
share one canonical stage structure (see ``ocp/transcribe.py``):

  stage variable  w_k = [x_k ; u_k ; dt_k (; xm_k)]   (nz = nx+nu+1 (+nx))
  interval rows   c_k(w_k, w_{k+1}) = 0               (defect + tie rows)

Every grid of the JAX package: the uniform finite-differences grid with dt
pinned or with one dt tied across the intervals (time-optimal); the
non-uniform time-optimal grids with a free dt per interval; multiple shooting
with dt pinned, tied or per interval; uncompressed Hermite-Simpson (the
interval midpoints appended to the stage vector, w_k = [x;u;dt;xm]); and
move blocking (u_{k+1} = u_k tie rows inside each block).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class Grid:
    """Static grid description."""

    N: int = 20
    kind: str = "fd"  # "fd" | "ms"
    fd_scheme: str = "crank_nicolson"
    integrator: str = "rk4"
    integrator_substeps: int = 1
    cost_integration: str = "left_sum"  # | trapezoidal | hermite_simpson[_lc|_unc]
    dt_mode: str = "fixed"  # | "single" | "per_interval"
    u_blocks: Optional[Tuple[int, ...]] = None

    @property
    def dt_is_variable(self) -> bool:
        return self.dt_mode != "fixed"

    @property
    def has_dt_tie(self) -> bool:
        return self.dt_mode == "single"

    @property
    def has_u_tie(self) -> bool:
        return self.u_blocks is not None

    def u_tie_mask(self, nu: int) -> np.ndarray:
        """[N-1, nu] mask: row k ties u_{k+1} == u_k (inside one block)."""
        m = np.zeros((max(self.N - 1, 0), nu), dtype=np.float64)
        if self.u_blocks is not None:
            blocks = np.asarray(self.u_blocks)
            if len(blocks) != self.N:
                raise ValueError(f"u_blocks must have length N={self.N}")
            m[blocks[1:] == blocks[:-1], :] = 1.0
        return m


def finite_differences_grid(N: int, fd_scheme: str = "crank_nicolson",
                            cost_integration: str = "left_sum") -> Grid:
    """Uniform full-discretization grid, fixed dt."""
    return Grid(N=N, kind="fd", fd_scheme=fd_scheme,
                cost_integration=cost_integration, dt_mode="fixed")


def hermite_simpson_uncompressed_grid(N: int) -> Grid:
    """Uncompressed Hermite-Simpson collocation: the interval midpoint states
    are decision variables with an explicit interpolation constraint, and the
    Simpson cost quadrature evaluates the decision midpoint. The midpoints
    are appended to the stage vector (w_k = [x;u;dt;xm]), so the interval
    rows stay coupled to two stages (``TranscribedOCP.n_aux``)."""
    return Grid(N=N, kind="fd", fd_scheme="hermite_simpson_unc",
                cost_integration="hermite_simpson_unc", dt_mode="fixed")


def finite_differences_variable_grid(N: int, fd_scheme: str = "crank_nicolson",
                                     cost_integration: str = "left_sum") -> Grid:
    """Uniform time-optimal grid: one dt decision variable, kept equal across
    the intervals by tie rows dt_{k+1} − dt_k = 0."""
    return Grid(N=N, kind="fd", fd_scheme=fd_scheme,
                cost_integration=cost_integration, dt_mode="single")


def non_uniform_fd_variable_grid(N: int, fd_scheme: str = "crank_nicolson",
                                 cost_integration: str = "left_sum") -> Grid:
    """Non-uniform time-optimal grid: a free dt_k decision variable per
    interval, no tie rows."""
    return Grid(N=N, kind="fd", fd_scheme=fd_scheme,
                cost_integration=cost_integration, dt_mode="per_interval")


def multiple_shooting_grid(N: int, integrator: str = "rk4",
                           substeps: int = 1,
                           cost_integration: str = "left_sum") -> Grid:
    """Multiple shooting, fixed dt: defect = solveIVP(x_k, u_k, dt) − x_{k+1}."""
    return Grid(N=N, kind="ms", integrator=integrator,
                integrator_substeps=substeps,
                cost_integration=cost_integration, dt_mode="fixed")


def multiple_shooting_variable_grid(N: int, integrator: str = "rk4",
                                    substeps: int = 1,
                                    cost_integration: str = "left_sum") -> Grid:
    """Time-optimal multiple shooting, one dt tied across the intervals."""
    return Grid(N=N, kind="ms", integrator=integrator,
                integrator_substeps=substeps,
                cost_integration=cost_integration, dt_mode="single")


def non_uniform_multiple_shooting_variable_grid(
        N: int, integrator: str = "rk4", substeps: int = 1,
        cost_integration: str = "left_sum") -> Grid:
    """Non-uniform time-optimal multiple shooting: a free dt_k per interval."""
    return Grid(N=N, kind="ms", integrator=integrator,
                integrator_substeps=substeps,
                cost_integration=cost_integration, dt_mode="per_interval")


def move_blocking_grid(N: int, blocks, fd_scheme: str = "crank_nicolson",
                       cost_integration: str = "left_sum") -> Grid:
    """Move-blocking full discretization: ``blocks`` is either a per-interval
    block-id sequence of length N or a list of block lengths summing to N."""
    blocks = list(blocks)
    if sum(blocks) == N and all(b >= 1 for b in blocks):
        blocks = [i for i, b in enumerate(blocks) for _ in range(b)]
    if len(blocks) != N:
        raise ValueError("blocks must be length-N ids or lengths summing to N")
    return Grid(N=N, kind="fd", fd_scheme=fd_scheme,
                cost_integration=cost_integration, dt_mode="fixed",
                u_blocks=tuple(int(b) for b in blocks))
