"""System output functions y = g(x), batch-first.

Counterpart of the JAX package's ``models/outputs.py``: the full state, the
first component, and a linear map C x. Every output takes x [..., nx] and
returns y [..., ny].
"""
from __future__ import annotations

import torch

from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class SystemOutput:
    """Base: full-state output y = x."""

    ny: int = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


def FullStateSystemOutput(nx: int) -> SystemOutput:
    return SystemOutput(ny=nx)


@plain_dataclass
class FirstStateSystemOutput(SystemOutput):
    """y = x[..., 0:1]."""

    ny: int = 1

    def __call__(self, x):
        return x[..., :1]


@plain_dataclass
class LinearStateSystemOutput(SystemOutput):
    """y = C x, C [ny, nx]."""

    C: torch.Tensor = None

    @staticmethod
    def from_matrix(C) -> "LinearStateSystemOutput":
        C = torch.as_tensor(C)
        return LinearStateSystemOutput(ny=C.shape[0], C=C)

    def __call__(self, x):
        return x @ self.C.to(x).T
