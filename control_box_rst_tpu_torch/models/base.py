"""Dynamics-model protocol.

Counterpart of the JAX package's ``models/base.py``. A system is a frozen
dataclass with a pure ``__call__(x, u) -> xdot`` (continuous) or ``x_next``
(discrete) that broadcasts over leading dims: x [..., nx], u [..., nu].
Linearization is exact (``torch.func.jacfwd``) for one unbatched point.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class SystemDynamics:
    """Base class for all dynamics models.

    Subclasses set ``nx``/``nu`` and implement ``__call__(x, u)``.
    ``continuous_time=True`` means ``__call__`` returns xdot; False means it
    returns x_{k+1} directly (discrete-time system).
    """

    nx: int = 0
    nu: int = 0
    continuous_time: bool = True

    def __call__(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def linear_A(self, x0: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
        """∂f/∂x at one point (x0 [nx], u0 [nu]) via forward-mode AD."""
        return torch.func.jacfwd(lambda x: self(x, u0))(x0)

    def linear_B(self, x0: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
        """∂f/∂u at one point via forward-mode AD."""
        return torch.func.jacfwd(lambda u: self(x0, u))(u0)

    def linearize(self, x0, u0) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.linear_A(x0, u0), self.linear_B(x0, u0)

    @property
    def is_linear(self) -> bool:
        return False


@plain_dataclass
class FunctionalDynamics(SystemDynamics):
    """A pure function ``fn(x, u) -> xdot`` (or ``x_next``) wrapped as a
    system; ``fn`` takes and returns batch-first tensors like any model."""

    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = None

    def __call__(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.fn(x, u)


def check_dimensions(system: SystemDynamics) -> None:
    """Sanity-check that the model maps (nx,), (nu,) -> (nx,): one
    evaluation at zeros, in the dtype and on the device of the model's first
    tensor field (float64 on the host when it holds none)."""
    tensors = [v for v in vars(system).values() if isinstance(v, torch.Tensor)]
    kw = (dict(dtype=tensors[0].dtype, device=tensors[0].device) if tensors
          else dict(dtype=torch.float64, device="cpu"))
    f = system(torch.zeros((system.nx,), **kw), torch.zeros((system.nu,), **kw))
    if f.shape != (system.nx,):
        raise ValueError(
            f"{type(system).__name__}: dynamics output shape {tuple(f.shape)} "
            f"!= (nx,) = ({system.nx},)"
        )
