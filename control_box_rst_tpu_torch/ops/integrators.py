"""Explicit numerical integrators, batch-first.

Counterpart of the JAX package's ``ops/integrators.py``: each integrator is a
Butcher tableau driven by an unrolled stage loop, the control held constant
over the step (zero-order hold). ``solve_ivp(f, x, u, dt)`` integrates
xdot = f(x, u) over [0, dt]; the multiple-shooting defect
``solve_ivp(x_k, u_k, dt_k) − x_{k+1}`` lives in ``ocp/transcribe.py``.

Operands broadcast over leading dims: x [..., nx], u [..., nu], dt [...] (or a
Python number), so one call steps every stage of every lane. The substep loop
(a ``lax.scan`` there) is a Python loop here.

The fixed-step explicit family (Euler, RK2 … RK7) is made by name
(``make_integrator``, and registered in the factory under the same names);
``AdaptiveStepIntegrator`` (Dormand-Prince 5(4) on a fixed budget of
substeps, each lane accepting or rejecting its own), ``MultiStageFixedStep``
and ``MultiStageScaled`` are constructed directly, as in the reference.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from control_box_rst_tpu_torch.core.factory import register
from control_box_rst_tpu_torch.utils.tree import plain_dataclass

DynamicsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# --------------------------------------------------------------------------
# Butcher tableaus (classical coefficients, float64 host constants)
# --------------------------------------------------------------------------

def _tableau(a, b, c):
    return (
        np.asarray(a, dtype=np.float64),
        np.asarray(b, dtype=np.float64),
        np.asarray(c, dtype=np.float64),
    )


_EULER = _tableau([[0.0]], [1.0], [0.0])

# Heun's method: k2 = f(x + dt k1), x2 = x + (k1+k2)/2
_RK2 = _tableau([[0, 0], [1.0, 0]], [0.5, 0.5], [0, 1.0])

# Kutta's third-order method
_RK3 = _tableau(
    [[0, 0, 0], [0.5, 0, 0], [-1, 2, 0]],
    [1 / 6, 4 / 6, 1 / 6],
    [0, 0.5, 1],
)

# Classical RK4
_RK4 = _tableau(
    [[0, 0, 0, 0], [0.5, 0, 0, 0], [0, 0.5, 0, 0], [0, 0, 1, 0]],
    [1 / 6, 1 / 3, 1 / 3, 1 / 6],
    [0, 0.5, 0.5, 1],
)

# 6-stage 5th-order method (k2 = f(x + 4/11 dt k1), …,
# x2 = x + (4 k1 + (16+√6) k5 + (16-√6) k6)/36)
_S6 = np.sqrt(6.0)
_RK5 = _tableau(
    [
        [0] * 6,
        [4 / 11, 0, 0, 0, 0, 0],
        [9 / 50, 11 / 50, 0, 0, 0, 0],
        [0, -11 / 4, 15 / 4, 0, 0, 0],
        [(81 + 9 * _S6) / 600, 0, (255 - 55 * _S6) / 600, (24 - 14 * _S6) / 600, 0, 0],
        [(81 - 9 * _S6) / 600, 0, (255 + 55 * _S6) / 600, (24 + 14 * _S6) / 600, 0, 0],
    ],
    [4 / 36, 0, 0, 0, (16 + _S6) / 36, (16 - _S6) / 36],
    [0, 4 / 11, 2 / 5, 1, 0.5, 0.5],
)

# Dormand-Prince 5(4): the 5th-order weights, and the embedded 4th-order
# weights of the error estimate (the adaptive integrator)
_DOPRI = _tableau(
    [
        [0, 0, 0, 0, 0, 0, 0],
        [1 / 5, 0, 0, 0, 0, 0, 0],
        [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
        [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
        [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
    ],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
    [0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1, 1],
)
_DOPRI_B4 = np.array(
    [5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40],
    dtype=np.float64,
)

# Butcher's classical 7-stage 6th-order method (the JAX package ships this
# one in place of a tableau that fails the order-2 condition)
_RK6 = _tableau(
    [
        [0, 0, 0, 0, 0, 0, 0],
        [1 / 3, 0, 0, 0, 0, 0, 0],
        [0, 2 / 3, 0, 0, 0, 0, 0],
        [1 / 12, 1 / 3, -1 / 12, 0, 0, 0, 0],
        [-1 / 16, 9 / 8, -3 / 16, -3 / 8, 0, 0, 0],
        [0, 9 / 8, -3 / 8, -3 / 4, 1 / 2, 0, 0],
        [9 / 44, -9 / 11, 63 / 44, 18 / 11, 0, -16 / 11, 0],
    ],
    [11 / 120, 0, 27 / 40, 27 / 40, -4 / 15, -4 / 15, 11 / 120],
    [0, 1 / 3, 2 / 3, 1 / 3, 1 / 2, 1 / 2, 1],
)

# Fehlberg's 11-stage RK7(8), 7th-order weights
_RK7 = _tableau(
    [
        [0] * 11,
        [2 / 27] + [0] * 10,
        [1 / 36, 3 / 36] + [0] * 9,
        [1 / 24, 0, 3 / 24] + [0] * 8,
        [80 / 192, 0, -300 / 192, 300 / 192] + [0] * 7,
        [1 / 20, 0, 0, 5 / 20, 4 / 20] + [0] * 6,
        [-25 / 108, 0, 0, 125 / 108, -260 / 108, 250 / 108] + [0] * 5,
        [93 / 900, 0, 0, 0, 244 / 900, -200 / 900, 13 / 900] + [0] * 4,
        [2, 0, 0, -53 / 6, 1408 / 90, -1070 / 90, 67 / 90, 3] + [0] * 3,
        [-12285 / 14580, 0, 0, 3105 / 14580, -105408 / 14580, 83970 / 14580,
         -4617 / 14580, 41310 / 14580, -1215 / 14580] + [0] * 2,
        [2383 / 4100, 0, 0, -8525 / 4100, 17984 / 4100, -15050 / 4100,
         2133 / 4100, 2250 / 4100, 1125 / 4100, 1800 / 4100, 0],
    ],
    [41 / 840, 0, 0, 0, 0, 272 / 840, 216 / 840, 216 / 840, 27 / 840,
     27 / 840, 41 / 840],
    [0, 2 / 27, 1 / 9, 1 / 6, 5 / 12, 1 / 2, 5 / 6, 1 / 6, 2 / 3, 1 / 3, 1],
)


def _dt_column(dt, x: torch.Tensor) -> torch.Tensor:
    """dt [...] (or a number) as a column [..., 1] that broadcasts against x."""
    if not isinstance(dt, torch.Tensor):
        dt = torch.tensor(dt, dtype=x.dtype, device=x.device)
    return dt.to(x.dtype)[..., None]


def _rk_step(tableau, f: DynamicsFn, x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One explicit Runge-Kutta step with ZOH control; ``dt`` is [..., 1]."""
    A, b, _ = tableau
    ks = []
    for i in range(len(b)):
        xi = x
        for j in range(i):
            if A[i][j] != 0.0:
                xi = xi + dt * float(A[i][j]) * ks[j]
        ks.append(f(xi, u))
    out = x
    for i in range(len(b)):
        if b[i] != 0.0:
            out = out + dt * float(b[i]) * ks[i]
    return out


# --------------------------------------------------------------------------
# Integrator objects
# --------------------------------------------------------------------------

@plain_dataclass
class ExplicitIntegrator:
    """Fixed-step explicit RK integrator defined by a Butcher tableau.

    ``solve_ivp(f, x, u, dt)`` integrates xdot = f(x, u) over [0, dt] with
    ``num_substeps`` equal substeps."""

    order: int = 4
    num_substeps: int = 1
    name: str = "rk4"

    def _tableau(self):
        return _TABLEAUS[self.name]

    def step(self, f: DynamicsFn, x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
        """Single step of size dt (no substepping)."""
        return _rk_step(self._tableau(), f, x, u, _dt_column(dt, x))

    def solve_ivp(self, f: DynamicsFn, x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
        if self.num_substeps == 1:
            return self.step(f, x, u, dt)
        h = _dt_column(dt, x) / self.num_substeps
        tab = self._tableau()
        for _ in range(self.num_substeps):
            x = _rk_step(tab, f, x, u, h)
        return x

    def solve_ivp_traj(self, f: DynamicsFn, x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
        """Integrate and return all substep states, [..., num_substeps+1, nx]."""
        h = _dt_column(dt, x) / self.num_substeps
        tab = self._tableau()
        traj = [x]
        for _ in range(self.num_substeps):
            traj.append(_rk_step(tab, f, traj[-1], u, h))
        return torch.stack(traj, dim=-2)


_TABLEAUS = {
    "euler": _EULER,
    "rk2": _RK2,
    "rk3": _RK3,
    "rk4": _RK4,
    "rk5": _RK5,
    "rk6": _RK6,
    "rk7": _RK7,
}

_ORDERS = {"euler": 1, "rk2": 2, "rk3": 3, "rk4": 4, "rk5": 5, "rk6": 6, "rk7": 7}

def make_integrator(name: str = "rk4", num_substeps: int = 1) -> ExplicitIntegrator:
    """Factory: euler | rk2..rk7."""
    if name not in _TABLEAUS:
        raise KeyError(f"unknown integrator {name!r}; have {sorted(_TABLEAUS)}")
    return ExplicitIntegrator(order=_ORDERS[name], num_substeps=num_substeps, name=name)


for _n in _TABLEAUS:
    register("integrator", _n)(
        lambda name=_n, num_substeps=1: make_integrator(name, num_substeps)
    )


@plain_dataclass
class AdaptiveStepIntegrator:
    """Embedded Dormand-Prince 5(4) with per-substep step-size control.

    A fixed budget of ``max_substeps`` DOPRI steps: each proposes h, is
    accepted where the embedded error estimate (the max over the state's
    components) is within ``abs_tol``, and rescales h by 0.9·(tol/err)^(1/5)
    clipped to [0.2, 5]. Every lane keeps its own (t, h) and accepts or
    rejects on its own; a lane whose accumulated time has reached dt stays
    where it is. The budget's Python loop is the reference's ``lax.scan``."""

    abs_tol: float = 1e-6
    max_substeps: int = 32

    def _dopri_pair(self, f: DynamicsFn, xk, u, h):
        A, b, _ = _DOPRI
        ks = []
        for i in range(7):
            xi = xk
            for j in range(i):
                if A[i][j] != 0.0:
                    xi = xi + h * float(A[i][j]) * ks[j]
            ks.append(f(xi, u))
        x5 = xk
        x4 = xk
        for i in range(7):
            if b[i] != 0.0:
                x5 = x5 + h * float(b[i]) * ks[i]
            if _DOPRI_B4[i] != 0.0:
                x4 = x4 + h * float(_DOPRI_B4[i]) * ks[i]
        return x5, x4

    def solve_ivp_accepted(self, f: DynamicsFn, x: torch.Tensor, u: torch.Tensor, dt):
        """(x(dt) [..., nx], accepted [..., max_substeps] bool): the state
        after the budget and which of its substeps each lane accepted."""
        dt = _dt_column(dt, x)[..., 0]
        lead = torch.broadcast_shapes(x.shape[:-1], dt.shape)
        dt = dt.expand(lead)
        x = x.expand(lead + x.shape[-1:])
        t = torch.zeros_like(dt)
        h = dt
        accepted = []
        for _ in range(self.max_substeps):
            remaining = dt - t
            h_eff = torch.minimum(h, remaining)
            x5, x4 = self._dopri_pair(f, x, u, h_eff[..., None])
            err = (x5 - x4).abs().amax(dim=-1)
            accept = err <= self.abs_tol
            done = remaining <= 1e-12
            keep = done | ~accept
            x = torch.where(keep[..., None], x, x5)
            t = torch.where(keep, t, t + h_eff)
            scale = 0.9 * (self.abs_tol / (err + 1e-30)) ** 0.2
            h = torch.where(done, h, h_eff * torch.clamp(scale, 0.2, 5.0))
            h = torch.maximum(h, dt * 1e-6)
            accepted.append(~keep)
        return x, torch.stack(accepted, dim=-1)

    def solve_ivp(self, f: DynamicsFn, x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
        return self.solve_ivp_accepted(f, x, u, dt)[0]


@plain_dataclass
class MultiStageFixedStep:
    """A fixed substep count: ``inner`` applied n times with h = dt/n."""

    inner: ExplicitIntegrator = None
    n: int = 10

    def solve_ivp(self, f, x, u, dt):
        return self.inner.replace(num_substeps=self.n).solve_ivp(f, x, u, dt)


@plain_dataclass
class MultiStageScaled:
    """The substep count scaled by dt, n = ceil(dt / dt_ref), statically
    bounded: as in the reference (where dt is traced), the count is fixed to
    ``n_max`` and the step is dt/n_max."""

    inner: ExplicitIntegrator = None
    dt_ref: float = 0.1
    n_max: int = 10

    def solve_ivp(self, f, x, u, dt):
        return self.inner.replace(num_substeps=self.n_max).solve_ivp(f, x, u, dt)
