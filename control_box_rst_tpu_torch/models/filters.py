"""One-step predictor (dead-time compensation), batch-first.

Counterpart of ``OneStepPredictor`` in the JAX package's
``models/filters.py``: it integrates the model over the pending control
sequence, so a controller can solve from where the plant will be when its
control takes effect. The moving filters and the dead-time buffer of that
module come with the periphery slice.
"""
from __future__ import annotations

import torch

from control_box_rst_tpu_torch.models.base import SystemDynamics
from control_box_rst_tpu_torch.ops.integrators import ExplicitIntegrator, make_integrator
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class OneStepPredictor:
    """Predict x(t + dt) from x(t) and the pending control sequence."""

    system: SystemDynamics = None
    integrator: ExplicitIntegrator = None

    def __post_init__(self):
        if self.integrator is None:
            object.__setattr__(self, "integrator", make_integrator("rk4", 2))

    def predict(self, x0: torch.Tensor, u_seq: torch.Tensor, dt_seq: torch.Tensor) -> torch.Tensor:
        """Integrate x0 [..., nx] through the piecewise-constant sequence
        u_seq [..., n, nu] on the time steps dt_seq [..., n]."""
        x = x0
        for i in range(u_seq.shape[-2]):
            u, dtk = u_seq[..., i, :], dt_seq[..., i]
            if self.system.continuous_time:
                x = self.integrator.solve_ivp(self.system, x, u, dtk)
            else:
                x = torch.where((dtk > 0)[..., None], self.system(x, u), x)
        return x

    def predict_single(self, x0: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
        """One interval of length dt under the control u [..., nu]."""
        dt = torch.as_tensor(dt, dtype=x0.dtype, device=x0.device)
        return self.predict(x0, u[..., None, :], dt[None])
