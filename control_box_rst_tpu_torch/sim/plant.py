"""Simulated plants and disturbances, batch-first.

Counterpart of the JAX package's ``sim/plant.py``. A plant advances the true
state of every lane over one control interval, x [B, nx] and u [B, nu], by
integrating the system dynamics under a zero-order-hold input (or applying a
discrete-time map), and reads an output from the state. Disturbances are
additive Gaussian noise drawn from an explicit ``torch.Generator`` (where the
reference splits ``jax.random`` keys): input noise is drawn before state
noise, and a noisy plant without a generator raises. A plant whose lanes
are a window of a larger batch (one rank's shard under a mesh) draws the
noise of the whole batch and keeps its window (``with_lane_window``), so a
lane's noise does not depend on how the batch is split.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from control_box_rst_tpu_torch.models.base import SystemDynamics
from control_box_rst_tpu_torch.ops.integrators import ExplicitIntegrator, make_integrator
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class GaussianNoise:
    """Additive Gaussian disturbance: mean + std · N(0, 1).

    ``lanes = (offset, total)``: ``like``'s lanes are lanes offset … offset +
    B − 1 of a batch of ``total``; the draw is the whole batch's, cut to
    them."""

    mean: float = 0.0
    std: float = 0.0
    lanes: Optional[Tuple[int, int]] = None

    def __call__(self, generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
        """A draw of ``like``'s shape, dtype and device."""
        if generator is None:
            raise ValueError("a noisy plant draws from an explicit torch.Generator")
        shape = like.shape
        if self.lanes is not None:
            shape = (self.lanes[1],) + tuple(like.shape[1:])
        z = torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)
        if self.lanes is not None:
            z = z[self.lanes[0]:self.lanes[0] + like.shape[0]]
        return self.mean + self.std * z


@plain_dataclass
class SimulatedPlant:
    """Integrates ``system`` over each control interval (ZOH input).

    output_kind: 'full' → y = x; 'first' → y = x[..., :1]; 'linear' →
    y = C x with C [ny, nx]."""

    system: SystemDynamics = None
    integrator: ExplicitIntegrator = None
    output_kind: str = "full"
    C: Optional[torch.Tensor] = None
    state_noise: Optional[GaussianNoise] = None
    output_noise: Optional[GaussianNoise] = None
    input_noise: Optional[GaussianNoise] = None

    def __post_init__(self):
        if self.output_kind not in ("full", "first", "linear"):
            raise KeyError(f"unknown output kind {self.output_kind!r}")
        if self.integrator is None:
            object.__setattr__(self, "integrator", make_integrator("rk4", 4))

    @property
    def nx(self) -> int:
        return self.system.nx

    def with_lane_window(self, offset: int, total: int) -> "SimulatedPlant":
        """This plant for lanes offset … of a batch of ``total``: each noise
        draws the whole batch's and keeps those lanes."""
        return self.replace(**{
            name: getattr(self, name).replace(lanes=(offset, total))
            for name in ("state_noise", "output_noise", "input_noise")
            if getattr(self, name) is not None})

    @property
    def ny(self) -> int:
        if self.output_kind == "full":
            return self.system.nx
        if self.output_kind == "first":
            return 1
        return self.C.shape[0]

    def step(self, x: torch.Tensor, u: torch.Tensor, dt, generator=None) -> torch.Tensor:
        """Advance the true state of every lane by one control interval."""
        if self.input_noise is not None:
            u = u + self.input_noise(generator, u)
        if self.system.continuous_time:
            x_next = self.integrator.solve_ivp(self.system, x, u, dt)
        else:
            x_next = self.system(x, u)
        if self.state_noise is not None:
            x_next = x_next + self.state_noise(generator, x_next)
        return x_next

    def output(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if self.output_kind == "full":
            y = x
        elif self.output_kind == "first":
            y = x[..., :1]
        else:
            y = torch.einsum("ij,...j->...i", self.C.to(x.dtype), x)
        if self.output_noise is not None:
            y = y + self.output_noise(generator, y)
        return y
