"""Benchmark dynamics systems.

Counterpart of the JAX package's ``models/benchmark.py``: the twelve
benchmark models with the same equations and default parameters, each
registered in this package's factory under the reference's name
(``Factory.create("system", "van_der_pol", a=2.0)``). Every model
broadcasts over leading dims: x [..., nx], u [..., nu].

Components are taken as slices (``x[..., :1]``), never as indices: forward
mode AD of a 0-dim tensor combined with a Python number yields float64
tangents for float32 inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from control_box_rst_tpu_torch.core.factory import register
from control_box_rst_tpu_torch.models.base import SystemDynamics
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


def _cols(x, n):
    """The first n components of x [..., ≥n] as n slices [..., 1]."""
    return [x[..., i:i + 1] for i in range(n)]


# --------------------------------------------------------------------------
# Linear benchmark systems
# --------------------------------------------------------------------------

@register("system", "serial_integrators")
@plain_dataclass
class SerialIntegratorSystem(SystemDynamics):
    """Chain of n integrators: x^(n) = u / T."""

    nx: int = 2
    nu: int = 1
    time_constant: float = 1.0

    def __call__(self, x, u):
        # xdot[i] = x[i+1] for i < n-1; xdot[n-1] = u / T
        return torch.cat([x[..., 1:], u[..., :1] / self.time_constant], dim=-1)

    @property
    def is_linear(self):
        return True


@register("system", "parallel_integrators")
@plain_dataclass
class ParallelIntegratorSystem(SystemDynamics):
    """n decoupled single integrators: xdot = T · u."""

    nx: int = 2
    nu: int = 2
    time_constant: float = 1.0

    def __call__(self, x, u):
        return self.time_constant * u

    @property
    def is_linear(self):
        return True


@register("system", "linear_state_space")
@plain_dataclass
class LinearStateSpaceModel(SystemDynamics):
    """xdot = A x + B u."""

    nx: int = 1
    nu: int = 1
    A: torch.Tensor = None
    B: torch.Tensor = None

    @staticmethod
    def from_matrices(A, B) -> "LinearStateSpaceModel":
        """A [nx, nx], B [nx, nu], rounded to float32 as the reference's
        ``from_matrices`` rounds them (held as float32 tensors on the host;
        ``tree_to`` moves them with the OCP or plant that holds the model)."""
        A = torch.as_tensor(np.array(A, dtype=np.float32))
        B = torch.as_tensor(np.array(B, dtype=np.float32))
        return LinearStateSpaceModel(nx=A.shape[0], nu=B.shape[1], A=A, B=B)

    def __call__(self, x, u):
        return x @ self.A.to(x).T + u @ self.B.to(x).T

    @property
    def is_linear(self):
        return True


@register("system", "double_integrator_discrete")
@plain_dataclass
class DoubleIntegratorDiscreteTime(SystemDynamics):
    """Exact discrete double integrator:
    x1+ = x1 + dt x2 + dt²/2 u;  x2+ = x2 + dt u."""

    nx: int = 2
    nu: int = 1
    continuous_time: bool = False
    dt: float = 1.0

    def __call__(self, x, u):
        x1, x2 = _cols(x, 2)
        u1 = u[..., :1]
        return torch.cat(
            [x1 + self.dt * x2 + 0.5 * self.dt ** 2 * u1, x2 + self.dt * u1], dim=-1)

    @property
    def is_linear(self):
        return True


def DoubleIntegratorContinuous(time_constant: float = 1.0) -> SerialIntegratorSystem:
    """Config-1 model: continuous double integrator."""
    return SerialIntegratorSystem(nx=2, nu=1, time_constant=time_constant)


# --------------------------------------------------------------------------
# Nonlinear benchmark systems
# --------------------------------------------------------------------------

@register("system", "van_der_pol")
@plain_dataclass
class VanDerPolOscillator(SystemDynamics):
    """xdot1 = x2; xdot2 = -a(x1²-1)x2 - x1 + u."""

    nx: int = 2
    nu: int = 1
    a: float = 1.0

    def __call__(self, x, u):
        x1, x2 = _cols(x, 2)
        return torch.cat(
            [x2, -self.a * (x1 ** 2 - 1.0) * x2 - x1 + u[..., :1]], dim=-1
        )


@register("system", "duffing")
@plain_dataclass
class DuffingOscillator(SystemDynamics):
    """xdot2 = -d x2 - α x1 - β x1³ + u."""

    nx: int = 2
    nu: int = 1
    damping: float = 1.0
    spring_alpha: float = 1.0
    spring_beta: float = 1.0

    def __call__(self, x, u):
        x1, x2 = _cols(x, 2)
        return torch.cat(
            [
                x2,
                -self.damping * x2
                - self.spring_alpha * x1
                - self.spring_beta * x1 ** 3
                + u[..., :1],
            ],
            dim=-1,
        )


@register("system", "free_space_rocket")
@plain_dataclass
class FreeSpaceRocket(SystemDynamics):
    """[s, v, m]: sdot = v; vdot = (u − 0.02 v²)/m; mdot = −0.01 u²."""

    nx: int = 3
    nu: int = 1

    def __call__(self, x, u):
        _, v, m = _cols(x, 3)
        u1 = u[..., :1]
        return torch.cat([v, (u1 - 0.02 * v ** 2) / m, -0.01 * u1 ** 2], dim=-1)


@register("system", "simple_pendulum")
@plain_dataclass
class SimplePendulum(SystemDynamics):
    """phiddot = u − rho/(m l²) phidot − g/l sin(phi)."""

    nx: int = 2
    nu: int = 1
    m: float = 0.205
    l: float = 0.34
    g: float = 9.81
    rho: float = 0.0

    def __call__(self, x, u):
        phi, phidot = _cols(x, 2)
        return torch.cat(
            [
                phidot,
                u[..., :1]
                - self.rho / (self.m * self.l ** 2) * phidot
                - self.g / self.l * torch.sin(phi),
            ],
            dim=-1,
        )


@register("system", "massless_pendulum")
@plain_dataclass
class MasslessPendulum(SystemDynamics):
    """phiddot = u − ω₀ sin(phi)."""

    nx: int = 2
    nu: int = 1
    omega0: float = 1.0

    def __call__(self, x, u):
        phi, phidot = _cols(x, 2)
        return torch.cat([phidot, u[..., :1] - self.omega0 * torch.sin(phi)], dim=-1)


@register("system", "cart_pole")
@plain_dataclass
class CartPole(SystemDynamics):
    """State [p, phi, pdot, phidot], force input; the standard cart-pole
    equations."""

    nx: int = 4
    nu: int = 1
    mc: float = 1.0
    mp: float = 0.3
    l: float = 0.5
    g: float = 9.81

    def __call__(self, x, u):
        _, phi, pdot, phidot = _cols(x, 4)
        u1 = u[..., :1]
        sin_phi = torch.sin(phi)
        cos_phi = torch.cos(phi)
        sin_phi_phidot_sq = sin_phi * phidot ** 2
        denom = self.mc + self.mp * (1.0 - cos_phi ** 2)
        acc = (
            self.l * self.mp * sin_phi_phidot_sq
            + u1
            + self.mp * self.g * cos_phi * sin_phi
        ) / denom
        ang = -(
            self.l * self.mp * cos_phi * sin_phi_phidot_sq
            + u1 * cos_phi
            + (self.mp + self.mc) * self.g * sin_phi
        ) / (self.l * denom)
        return torch.cat([pdot, phidot, acc, ang], dim=-1)


@register("system", "toy_example")
@plain_dataclass
class ToyExample(SystemDynamics):
    """The quasi-infinite-horizon NMPC toy system."""

    nx: int = 2
    nu: int = 1
    mu: float = 0.5

    def __call__(self, x, u):
        x1, x2 = _cols(x, 2)
        u1 = u[..., :1]
        return torch.cat(
            [
                x2 + u1 * (self.mu + (1.0 - self.mu) * x1),
                x1 + u1 * (self.mu - 4.0 * (1.0 - self.mu) * x2),
            ],
            dim=-1,
        )


@register("system", "artsteins_circle")
@plain_dataclass
class ArtsteinsCircle(SystemDynamics):
    """xdot1 = (x1² − x2²) u; xdot2 = 2 x1 x2 u."""

    nx: int = 2
    nu: int = 1

    def __call__(self, x, u):
        x1, x2 = _cols(x, 2)
        u1 = u[..., :1]
        return torch.cat([(x1 ** 2 - x2 ** 2) * u1, 2.0 * x1 * x2 * u1], dim=-1)


ALL_BENCHMARK_SYSTEMS = [
    SerialIntegratorSystem,
    ParallelIntegratorSystem,
    LinearStateSpaceModel,
    DoubleIntegratorDiscreteTime,
    VanDerPolOscillator,
    DuffingOscillator,
    FreeSpaceRocket,
    SimplePendulum,
    MasslessPendulum,
    CartPole,
    ToyExample,
    ArtsteinsCircle,
]
