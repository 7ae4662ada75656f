"""Core enums and status codes (the port's own copy).

Same codes as the JAX package's ``core/types.py`` so results compare
directly: each lane of a batched solve carries its own int32 status.
"""
from __future__ import annotations

import enum


class SolverStatus(enum.IntEnum):
    """Per-solve outcome. Stored as int32 inside solver states."""

    ERROR = 0
    CONVERGED = 1
    EARLY_TERMINATED = 2   # iteration budget exhausted before tolerance met
    INFEASIBLE = 3         # constraint violation not decreasing / diverged


class ControllerStatus(enum.IntEnum):
    """Outcome of one controller step (the reference's ``step()`` bool)."""

    OK = 1
    FAILED = 0
