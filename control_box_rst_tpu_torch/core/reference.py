"""Reference trajectories.

Counterpart of the JAX package's ``core/reference.py``: a reference is a
function t → value [d], evaluated for a tensor of times at once
(``value_at(t [...]) -> [..., d]``), and ``sample_references`` materializes
the per-stage reference arrays a transcribed OCP consumes.

The reference library's blind discrete-time reference (samples stepped
through without time synchronization) stays a note here, as it is in the
JAX package: use ``DiscreteTimeReferenceTrajectory`` with
``interpolation='zero_order_hold'`` and pre-shifted times for it.
"""
from __future__ import annotations

import torch

from control_box_rst_tpu_torch.core.time_series import TimeSeries
from control_box_rst_tpu_torch.ocp.problem import References
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


def _stage_times(t0, dts: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(dts.shape[:-1] + (1,), dtype=dts.dtype, device=dts.device)
    return t0 + torch.cat([zero, torch.cumsum(dts, dim=-1)], dim=-1)


@plain_dataclass
class ReferenceTrajectory:
    """Base: subclasses implement value_at(t [...]) -> [..., d]."""

    dim: int = 0

    def value_at(self, t) -> torch.Tensor:
        raise NotImplementedError

    def stage_values(self, t0, dts: torch.Tensor) -> torch.Tensor:
        """Values at the stage times t0, t0+dt0, … — [N+1, d]."""
        return self.value_at(_stage_times(t0, dts))


@plain_dataclass
class StaticReference(ReferenceTrajectory):
    """Constant reference."""

    value: torch.Tensor = None

    def value_at(self, t):
        t = torch.as_tensor(t)
        return self.value.expand(tuple(t.shape) + tuple(self.value.shape))


def ZeroReference(dim: int, dtype=torch.float64) -> StaticReference:
    return StaticReference(dim=dim, value=torch.zeros((dim,), dtype=dtype))


@plain_dataclass
class SineReferenceTrajectory(ReferenceTrajectory):
    """value_i = offset + amplitude · sin(omega t + phase)."""

    amplitude: object = 1.0
    omega: object = 1.0
    phase: object = 0.0
    offset: object = 0.0

    def value_at(self, t):
        t = torch.as_tensor(t, dtype=torch.float64) if not isinstance(t, torch.Tensor) else t
        v = self.offset + self.amplitude * torch.sin(self.omega * t[..., None] + self.phase)
        return v.expand(tuple(t.shape) + (self.dim,))


@plain_dataclass
class DiscreteTimeReferenceTrajectory(ReferenceTrajectory):
    """Reference stored as a TimeSeries, interpolated in time."""

    series: TimeSeries = None
    interpolation: str = "linear"

    def value_at(self, t):
        return self.series.value_at(t, interpolation=self.interpolation)


def sample_references(
    xref: ReferenceTrajectory,
    uref: ReferenceTrajectory,
    t0,
    dts: torch.Tensor,
) -> References:
    """Per-stage reference arrays of a grid: xref at the N+1 stage times,
    uref at the N interval starts."""
    ts = _stage_times(t0, dts)
    return References(xref=xref.value_at(ts), uref=uref.value_at(ts[..., :-1]))

