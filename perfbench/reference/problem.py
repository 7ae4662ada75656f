"""The benchmark's optimal-control problems, stated from a configuration file.

A plain statement of what a configuration under ``perfbench/configs/`` asks
for, written from the upstream formulation and not from the program:

    min  sum_{k<N} (x_k' Q x_k + u_k' R u_k) + x_N' Qf x_N
    s.t. x_0 = x0,  x_{k+1} = Phi(x_k, u_k),  u_lo <= u_k <= u_hi

``Phi`` is the configuration's discretisation of the continuous dynamics
with the control held over the interval: Crank-Nicolson finite differences
(``0.5 (f(x_k, u_k) + f(x_{k+1}, u_k)) = (x_{k+1} - x_k) / dt``, solved
exactly for a linear system) or explicit RK4 steps (multiple shooting). The
plant of a closed loop integrates the same dynamics by RK4 in equal substeps
under a zero-order hold. Imports torch only.

A system is ``systems/<name>.py`` (``dynamics(params)``, and ``linear(params)``
for a linear one) and a discretisation ``schemes/<scheme>.py``
(``step(system, params, grid, dtype, device)``), both found by the names in
the configuration file.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch


def rk4(f, x, u, dt: float, substeps: int):
    h = dt / substeps
    for _ in range(substeps):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


@dataclasses.dataclass(frozen=True)
class Problem:
    """One configuration's OCP, in the dtype and on the device it is given."""

    N: int
    dt: float
    nx: int
    nu: int
    f: Callable
    step: Callable          # Phi(x [B, nx], u [B, nu]) -> x_next
    plant_step: Callable    # the closed loop's plant over one interval
    Q: torch.Tensor
    R: torch.Tensor
    Qf: torch.Tensor
    u_lo: float
    u_hi: float


def build(config: dict, dtype=torch.float64, device="cpu") -> Problem:
    """The OCP of a configuration file's contents, in ``dtype`` on ``device``."""
    sysc, grid, cost = config["system"], config["grid"], config["cost"]
    system = importlib.import_module(f"perfbench.reference.systems.{sysc['name']}")
    scheme = importlib.import_module(f"perfbench.reference.schemes.{grid['scheme']}")
    f = system.dynamics(sysc)
    kw = dict(dtype=dtype, device=device)
    Q, R, Qf = (torch.tensor(cost[k], **kw) for k in ("Q", "R", "Qf"))
    nx, nu = Q.shape[0], R.shape[0]
    dt, N = float(grid["dt"]), int(grid["N"])
    step = scheme.step(system, sysc, grid, dtype, device)
    plant = config.get("plant", {"integrator": "rk4", "substeps": 4})
    if plant["integrator"] != "rk4":
        raise KeyError(f"unknown plant integrator {plant['integrator']!r}")
    psub = int(plant["substeps"])
    lo, hi = config["u_bounds"]
    return Problem(N=N, dt=dt, nx=nx, nu=nu, f=f, step=step,
                   plant_step=lambda x, u: rk4(f, x, u, dt, psub),
                   Q=Q, R=R, Qf=Qf, u_lo=float(lo), u_hi=float(hi))
