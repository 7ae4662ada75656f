"""Observers, batch-first.

Counterpart of the JAX package's ``sim/observer.py``: the passthrough
``NoObserver`` (the only observer of the reference library) and the
steady-state Kalman filter on a linear(ized) discrete model, its gain from
the filter DARE (``ops/matrix_eq.py:solve_dare``), computed once, at
construction. ``from_plant`` builds it as the JAX package's config loader
does: on the plant's linearization at the origin, ZOH-discretized by the
augmented matrix exponential.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from control_box_rst_tpu_torch.ops.matrix_eq import solve_dare
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype
from control_box_rst_tpu_torch.utils.tree import plain_dataclass, tree_to


@plain_dataclass
class NoObserver:
    """y IS the full state."""

    def init_carry(self, x0):
        return ()

    def observe(self, carry, y, u, dt):
        return carry, y


class KalmanCarry(NamedTuple):
    x_hat: torch.Tensor  # [B, nx]


def zoh_discretize(A: torch.Tensor, B: torch.Tensor, dt: float):
    """(Ad, Bd) of ẋ = Ax + Bu under a zero-order-hold input over dt: the
    blocks of exp([[A, B], [0, 0]]·dt)."""
    nx, nu = A.shape[-1], B.shape[-1]
    M = A.new_zeros((nx + nu, nx + nu))
    M[:nx, :nx] = A
    M[:nx, nx:] = B
    E = torch.linalg.matrix_exp(M * dt)
    return E[:nx, :nx], E[:nx, nx:]


@plain_dataclass
class SteadyStateKalmanObserver:
    """Discrete steady-state Kalman filter:
    x̂⁺ = Ad x̂ + Bd u + L (y − C (Ad x̂ + Bd u)), L from the filter DARE."""

    Ad: torch.Tensor = None
    Bd: torch.Tensor = None
    C: torch.Tensor = None
    L: torch.Tensor = None

    @staticmethod
    def from_linear(Ad, Bd, C, W=None, V=None) -> "SteadyStateKalmanObserver":
        """L = P Cᵀ (C P Cᵀ + V)⁻¹ with P the filter DARE's solution on (Adᵀ,
        Cᵀ, W, V); W defaults to 1e-3·I, V to 1e-2·I. Computed in the dtype
        and on the device of Ad."""
        Ad = torch.as_tensor(Ad)
        kw = dict(dtype=Ad.dtype, device=Ad.device)
        Bd, C = torch.as_tensor(Bd, **kw), torch.as_tensor(C, **kw)
        nx, ny = Ad.shape[0], C.shape[0]
        W = torch.eye(nx, **kw) * 1e-3 if W is None else torch.as_tensor(W, **kw)
        V = torch.eye(ny, **kw) * 1e-2 if V is None else torch.as_tensor(V, **kw)
        P = solve_dare(Ad.T, C.T, W, V)
        L = P @ C.T @ torch.linalg.inv(C @ P @ C.T + V)
        return SteadyStateKalmanObserver(Ad=Ad, Bd=Bd, C=C, L=L)

    @staticmethod
    def from_plant(plant, dt: float, W=None, V=None, dtype=None,
                   device=None) -> "SteadyStateKalmanObserver":
        """The filter on ``plant``'s system linearized at the origin
        (ZOH-discretized over ``dt`` for a continuous-time system) with the
        plant's output map (full state, the first component, or its C).
        Computed on the host in float64, then moved to ``device`` (``None``
        means the card and raises when there is none) as ``dtype`` (``None``
        means float32)."""
        host = dict(dtype=torch.float64, device="cpu")
        system = plant.system
        x0 = torch.zeros(system.nx, **host)
        u0 = torch.zeros(system.nu, **host)
        A, B = system.linear_A(x0, u0), system.linear_B(x0, u0)
        Ad, Bd = zoh_discretize(A, B, dt) if system.continuous_time else (A, B)
        if plant.output_kind == "full":
            C = torch.eye(system.nx, **host)
        elif plant.output_kind == "first":
            C = torch.eye(system.nx, **host)[:1]
        else:
            C = torch.as_tensor(plant.C, **host)
        obs = SteadyStateKalmanObserver.from_linear(Ad, Bd, C, W=W, V=V)
        return tree_to(obs, resolve_device(device), resolve_dtype(dtype))

    def init_carry(self, x0):
        return KalmanCarry(x_hat=x0)

    def observe(self, carry: KalmanCarry, y, u, dt):
        x_pred = carry.x_hat @ self.Ad.T + u @ self.Bd.T
        x_hat = x_pred + (y - x_pred @ self.C.T) @ self.L.T
        return KalmanCarry(x_hat=x_hat), x_hat
