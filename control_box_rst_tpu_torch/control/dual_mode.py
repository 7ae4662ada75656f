"""Dual-mode controller, batch-first: MPC far from the goal, a local
controller (LQR) near it.

Counterpart of the JAX package's ``control/dual_mode.py``: a lane switches to
the local controller when its state enters the terminal ball
‖x − xf‖²_S ≤ γ and, with ``latch``, stays there once it has entered. Both
controllers step every lane at every step (the MPC solve dominates and keeps
the batch's shapes fixed), and each lane's output is a ``torch.where`` on its
own switch; the latch is per lane.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from control_box_rst_tpu_torch.control.base import Controller, ControlOutput
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


class DualModeCarry(NamedTuple):
    mpc_carry: object
    local_carry: object
    local_active: torch.Tensor  # [B] bool, latched once entered (with ``latch``)


def _quad(d: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    return (d[..., :, None] * S * d[..., None, :]).sum(dim=(-2, -1))


@plain_dataclass
class DualModeController(Controller):
    global_controller: Controller = None  # typically a PredictiveController
    local_controller: Controller = None   # typically an LqrController
    S: torch.Tensor = None                # terminal ball metric [nx, nx]
    gamma: float = 1.0
    xf: torch.Tensor = None               # [nx]
    latch: bool = False                   # stay local once switched

    @property
    def horizon(self) -> int:
        return self.global_controller.horizon

    def to(self, device=None, dtype=None) -> "DualModeController":
        """Both controllers and S, xf on ``device`` as ``dtype``; the global
        controller is rebuilt there by its own ``to``."""
        cast = lambda a: a.to(device=device, dtype=dtype)
        return self.replace(
            global_controller=self.global_controller.to(device, dtype),
            local_controller=self.local_controller.to(device, dtype),
            S=cast(self.S), xf=cast(self.xf))

    def init_carry(self, x0):
        return DualModeCarry(
            mpc_carry=self.global_controller.init_carry(x0),
            local_carry=self.local_controller.init_carry(x0),
            local_active=torch.zeros(x0.shape[:-1], dtype=torch.bool, device=x0.device),
        )

    def step(self, carry: DualModeCarry, x, t, dt):
        inside = _quad(x - self.xf, self.S) <= self.gamma
        active = inside | carry.local_active if self.latch else inside
        mpc_carry, mpc_out = self.global_controller.step(carry.mpc_carry, x, t, dt)
        loc_carry, loc_out = self.local_controller.step(carry.local_carry, x, t, dt)
        a1 = active[..., None]
        out = ControlOutput(
            u=torch.where(a1, loc_out.u, mpc_out.u),
            u_seq=torch.where(a1[..., None], loc_out.u[..., None, :].expand_as(mpc_out.u_seq),
                              mpc_out.u_seq),
            x_seq=mpc_out.x_seq,
            ok=torch.where(active, loc_out.ok, mpc_out.ok),
            info={**mpc_out.info, "local_active": active},
        )
        return DualModeCarry(mpc_carry, loc_carry, active), out
