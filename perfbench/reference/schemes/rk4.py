"""Multiple shooting: ``substeps`` explicit RK4 steps over the interval, the
control held."""
from perfbench.reference.problem import rk4


def step(system, params, grid, dtype, device):
    f, dt, sub = system.dynamics(params), float(grid["dt"]), int(grid.get("substeps", 1))
    return lambda x, u: rk4(f, x, u, dt, sub)
