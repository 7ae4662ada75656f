"""Controller protocol, batch-first.

Counterpart of the JAX package's ``control/base.py``. A controller is a
transition function

    step(carry, x, t, dt) -> (carry', ControlOutput)

over a batch of plants: x [B, nx], and every field of the carry and of the
output carries the batch as its leading dim. The reference composes the
closed loop as a ``lax.scan`` of an unbatched step under ``vmap``; here the
closed loop is a Python loop over the steps of one batched step
(``sim/closed_loop.py``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from control_box_rst_tpu_torch.utils.tree import plain_dataclass, tree_to


class ControlOutput(NamedTuple):
    """What one controller step produces, for every lane of the batch.

    u:      [B, nu] immediate control (applied ZOH over the next interval)
    u_seq:  [B, H, nu] predicted control sequence (H = 1 for static
            controllers)
    x_seq:  [B, H+1, nx] predicted state sequence
    ok:     [B] bool success flag
    info:   dict of diagnostics, each value [B, …]
    """

    u: torch.Tensor
    u_seq: torch.Tensor
    x_seq: torch.Tensor
    ok: torch.Tensor
    info: dict


@plain_dataclass
class Controller:
    """Base controller. Subclasses define ``init_carry`` / ``step``."""

    nx: int = 0
    nu: int = 0

    def init_carry(self, x0: torch.Tensor) -> Any:
        return ()

    def step(self, carry, x: torch.Tensor, t, dt) -> tuple:
        raise NotImplementedError

    @property
    def horizon(self) -> int:
        """Length of the produced u_seq (1 for static feedback)."""
        return 1

    def to(self, device=None, dtype=None) -> "Controller":
        """Copy with every tensor on ``device`` (floating ones as ``dtype``)."""
        return tree_to(self, device, dtype)

    def _single(self, x, u, ok=True, info=None) -> ControlOutput:
        """The output of a static controller: u [B, nu] held for one
        interval, the state held over it."""
        return ControlOutput(
            u=u,
            u_seq=u[..., None, :],
            x_seq=torch.stack([x, x], dim=-2),
            ok=torch.as_tensor(ok, device=u.device).expand(u.shape[:-1]),
            info=info or {},
        )
