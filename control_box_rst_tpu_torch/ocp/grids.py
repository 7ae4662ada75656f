"""Discretization grids.

Counterpart of the JAX package's ``ocp/grids.py``: a grid is a static
description of how the trajectory arrays parameterize the NLP. All variants
share one canonical stage structure (see ``ocp/transcribe.py``):

  stage variable  w_k = [x_k ; u_k ; dt_k]   (nz = nx+nu+1, always)
  interval rows   c_k(w_k, w_{k+1}) = 0      (defect + tie rows)

Ported: the ``Grid`` description; the uniform finite-differences grid with
dt pinned or with one dt tied across the intervals (time-optimal); the
non-uniform time-optimal grids with a free dt per interval; multiple shooting
with dt pinned, tied or per interval. Move blocking and Hermite-Simpson come
with a later slice, and the transcription refuses what it cannot yet
evaluate.
"""
from __future__ import annotations

from typing import Optional, Tuple

from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class Grid:
    """Static grid description."""

    N: int = 20
    kind: str = "fd"  # "fd" | "ms"
    fd_scheme: str = "crank_nicolson"
    integrator: str = "rk4"
    integrator_substeps: int = 1
    cost_integration: str = "left_sum"  # | "trapezoidal"
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


def finite_differences_grid(N: int, fd_scheme: str = "crank_nicolson",
                            cost_integration: str = "left_sum") -> Grid:
    """Uniform full-discretization grid, fixed dt."""
    return Grid(N=N, kind="fd", fd_scheme=fd_scheme,
                cost_integration=cost_integration, dt_mode="fixed")


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
