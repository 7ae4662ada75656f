"""Benchmark dynamics systems.

Counterpart of the JAX package's ``models/benchmark.py``; this slice carries
the integrator chain only (config 1's double integrator). The other models
come with the slices that need them.
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
