"""Classic controllers, batch-first: LQR, PID, simple state feedback, step
response.

Counterpart of the JAX package's ``control/classic.py``. Every controller
takes a batch of states x [B, nx] and returns controls [B, nu]; a carry (the
PID's errors) carries the batch as its leading dim. Gains are built once, at
construction (``LqrController.from_system`` solves the Riccati equation
there).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from control_box_rst_tpu_torch.control.base import Controller
from control_box_rst_tpu_torch.ops.matrix_eq import lqr_gain_continuous, lqr_gain_discrete
from control_box_rst_tpu_torch.ops.smallmat import mv_small
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class LqrController(Controller):
    """u = uref − K (x − xref), K from the CARE (continuous) or DARE
    (discrete) at the linearization (xref, uref)."""

    K: torch.Tensor = None
    xref: torch.Tensor = None
    uref: torch.Tensor = None

    @staticmethod
    def from_system(system, Q, R, xref=None, uref=None, dtype=None,
                    device=None) -> "LqrController":
        """Linearize ``system`` at (xref, uref) (zeros when not given) and
        solve the Riccati equation for K, once, here: on the host in float64,
        then moved to ``device`` (``None`` means the card and raises when
        there is none) as ``dtype`` (``None`` means float32)."""
        host = dict(dtype=torch.float64, device="cpu")
        as_host = lambda a: torch.as_tensor(a, **host)
        xref = torch.zeros(system.nx, **host) if xref is None else as_host(xref)
        uref = torch.zeros(system.nu, **host) if uref is None else as_host(uref)
        A = system.linear_A(xref, uref)
        B = system.linear_B(xref, uref)
        gain = lqr_gain_continuous if system.continuous_time else lqr_gain_discrete
        K = gain(A, B, as_host(Q), as_host(R))
        ctrl = LqrController(nx=system.nx, nu=system.nu, K=K, xref=xref, uref=uref)
        return ctrl.to(resolve_device(device), resolve_dtype(dtype))

    def step(self, carry, x, t, dt):
        u = self.uref - mv_small(self.K, x - self.xref)
        return carry, self._single(x, u)


class PidCarry(NamedTuple):
    p_error: torch.Tensor  # [B, nu] the previous step's error
    i_error: torch.Tensor  # [B, nu] the integrated error


@plain_dataclass
class PidController(Controller):
    """nu independent PIDs on the first nu components of (xref − x):
    u_i = p·e_i + i·∫e_i + d·de_i/dt."""

    p_gain: object = 1.0
    i_gain: object = 0.0
    d_gain: object = 0.0
    xref: Optional[torch.Tensor] = None

    def init_carry(self, x0):
        z = x0.new_zeros(x0.shape[:-1] + (self.nu,))
        return PidCarry(p_error=z, i_error=z)

    def step(self, carry: PidCarry, x, t, dt):
        xref = self.xref if self.xref is not None else torch.zeros_like(x)
        e = (xref - x)[..., : self.nu]
        dt_t = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
        d_error = torch.where(dt_t > 0, (e - carry.p_error) / dt_t, torch.zeros_like(e))
        i_error = carry.i_error + dt_t * e
        u = self.p_gain * e + self.i_gain * i_error + self.d_gain * d_error
        return PidCarry(p_error=e, i_error=i_error), self._single(x, u)


@plain_dataclass
class SimpleStateController(Controller):
    """u = K (xref − x) + uref, or the prefilter form u = −K x + V xref."""

    K: torch.Tensor = None
    V: Optional[torch.Tensor] = None
    xref: Optional[torch.Tensor] = None
    uref: Optional[torch.Tensor] = None

    def step(self, carry, x, t, dt):
        xref = self.xref if self.xref is not None else torch.zeros_like(x)
        if self.V is not None:
            u = -mv_small(self.K, x) + mv_small(self.V, xref)
        else:
            uref = self.uref if self.uref is not None else x.new_zeros((self.nu,))
            u = mv_small(self.K, xref - x) + uref
        return carry, self._single(x, u)


@plain_dataclass
class StepResponseGenerator(Controller):
    """Open-loop step input: u = u_step for t ≥ t_step, else u_init."""

    u_step: torch.Tensor = None
    u_init: Optional[torch.Tensor] = None
    t_step: float = 0.0

    def step(self, carry, x, t, dt):
        u_init = self.u_init if self.u_init is not None else torch.zeros_like(self.u_step)
        u = self.u_step if float(t) >= float(self.t_step) else u_init
        return carry, self._single(x, u.to(x.dtype).expand(x.shape[:-1] + u.shape[-1:]))
