"""Observers.

Counterpart of the JAX package's ``sim/observer.py``: the passthrough
``NoObserver`` (the only observer of the reference library). The JAX
package's steady-state Kalman observer needs the discrete algebraic Riccati
solver (``ops/matrix_eq.py:solve_dare``), which comes with the periphery
slice; until then it raises by name.
"""
from __future__ import annotations

from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class NoObserver:
    """y IS the full state."""

    def init_carry(self, x0):
        return ()

    def observe(self, carry, y, u, dt):
        return carry, y


class SteadyStateKalmanObserver:
    """Not ported yet: needs ``ops/matrix_eq.py:solve_dare`` (periphery
    slice F)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SteadyStateKalmanObserver is not ported yet: it needs "
            "ops/matrix_eq.py:solve_dare (periphery slice F)")

    @staticmethod
    def from_linear(*args, **kwargs):
        return SteadyStateKalmanObserver()
