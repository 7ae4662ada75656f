"""Benchmark dynamics systems.

Counterpart of the JAX package's ``models/benchmark.py``; the port carries
the integrator chain (configs 1 and 3: the double integrator) and the Van der
Pol oscillator (config 2). The other models come with the slices that need
them. Every model broadcasts over leading dims: x [..., nx], u [..., nu].
"""
from __future__ import annotations

import torch

from control_box_rst_tpu_torch.models.base import SystemDynamics
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


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


def DoubleIntegratorContinuous(time_constant: float = 1.0) -> SerialIntegratorSystem:
    """Config-1 model: continuous double integrator."""
    return SerialIntegratorSystem(nx=2, nu=1, time_constant=time_constant)


# --------------------------------------------------------------------------
# Nonlinear benchmark systems
# --------------------------------------------------------------------------

@plain_dataclass
class VanDerPolOscillator(SystemDynamics):
    """xdot1 = x2; xdot2 = -a(x1²-1)x2 - x1 + u."""

    nx: int = 2
    nu: int = 1
    a: float = 1.0

    def __call__(self, x, u):
        # trailing dims kept (slices, not indices): forward-mode AD of a
        # 0-dim tensor combined with a Python number yields float64 tangents
        x1, x2 = x[..., :1], x[..., 1:2]
        return torch.cat(
            [x2, -self.a * (x1 ** 2 - 1.0) * x2 - x1 + u[..., :1]], dim=-1
        )
