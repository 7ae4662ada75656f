"""Finite-difference collocation defects and quadrature rules.

Counterpart of the JAX package's ``ops/collocation.py``. Sign convention as
there: defect = f(·) − (x2 − x1)/dt. All operands broadcast over leading dims
(``dt`` is [...], states are [..., nx], controls [..., nu]); a stage cost
``l(x, u)`` returns [...].
"""
from __future__ import annotations

import torch


def _col(dt):
    """dt [...] as a column against [..., n] operands."""
    return dt[..., None]


# --------------------------------------------------------------------------
# FD collocation defects (equality constraints for full-discretization grids)
# --------------------------------------------------------------------------

def forward_diff_defect(f, x1, u1, x2, dt):
    """Forward Euler defect: f(x1,u1) − (x2−x1)/dt."""
    return f(x1, u1) - (x2 - x1) / _col(dt)


def backward_diff_defect(f, x1, u1, x2, dt):
    """Backward Euler defect: f(x2,u1) − (x2−x1)/dt."""
    return f(x2, u1) - (x2 - x1) / _col(dt)


def midpoint_diff_defect(f, x1, u1, x2, dt):
    """Midpoint defect: f((x1+x2)/2, u1) − (x2−x1)/dt."""
    return f(0.5 * (x1 + x2), u1) - (x2 - x1) / _col(dt)


def crank_nicolson_defect(f, x1, u1, x2, dt):
    """Crank-Nicolson defect: 0.5(f(x1,u1)+f(x2,u1)) − (x2−x1)/dt."""
    return 0.5 * (f(x1, u1) + f(x2, u1)) - (x2 - x1) / _col(dt)


def hermite_simpson_defect(f, x1, u1, x2, dt):
    """Hermite-Simpson defect (1/dt scaled): (f1 + 4 fm + f2)/6 − (x2−x1)/dt
    with the Hermite-interpolated midpoint xm = (x1+x2)/2 + dt/8 (f1 − f2)."""
    f1 = f(x1, u1)
    f2 = f(x2, u1)
    xm = 0.5 * (x1 + x2) + (_col(dt) / 8.0) * (f1 - f2)
    fm = f(xm, u1)
    return (f1 + 4.0 * fm + f2) / 6.0 - (x2 - x1) / _col(dt)


def hermite_simpson_lc_defect(f, x1, u1, x2, u2, dt):
    """Hermite-Simpson defect with linear control interpolation: the
    midpoint dynamics take um = (u1+u2)/2, the end points their own
    controls. ``u2`` is the next stage's control."""
    um = 0.5 * (u1 + u2)
    f1 = f(x1, u1)
    f2 = f(x2, u2)
    xm = 0.5 * (x1 + x2) + (_col(dt) / 8.0) * (f1 - f2)
    fm = f(xm, um)
    return (f1 + 4.0 * fm + f2) / 6.0 - (x2 - x1) / _col(dt)


def hermite_simpson_unc_rows(f, x1, xm, u1, x2, dt):
    """Uncompressed Hermite-Simpson interval rows, the midpoint state ``xm``
    a decision variable: [..., 2·nx] =
      simpson = (f1 + 4 f(xm) + f2)/6 − (x2 − x1)/dt          (dynamics)
      midtie  = (xm − (x1+x2)/2)/dt − (f1 − f2)/8             (interpolation)
    """
    f1 = f(x1, u1)
    f2 = f(x2, u1)
    fm = f(xm, u1)
    simpson = (f1 + 4.0 * fm + f2) / 6.0 - (x2 - x1) / _col(dt)
    midtie = (xm - 0.5 * (x1 + x2)) / _col(dt) - (f1 - f2) / 8.0
    return torch.cat([simpson, midtie], dim=-1)


FD_COLLOCATIONS = {
    "forward": forward_diff_defect,
    "backward": backward_diff_defect,
    "midpoint": midpoint_diff_defect,
    "crank_nicolson": crank_nicolson_defect,
    "hermite_simpson": hermite_simpson_defect,
}


def get_fd_collocation(name: str):
    if name not in FD_COLLOCATIONS:
        raise KeyError(f"unknown FD collocation {name!r}; have {sorted(FD_COLLOCATIONS)}")
    return FD_COLLOCATIONS[name]


# --------------------------------------------------------------------------
# Quadrature rules for integral stage costs over one interval [0, dt]
# --------------------------------------------------------------------------

def quadrature_left_sum(l, x1, u1, x2, dt):
    """Rectangle / left-sum rule: dt · l(x1, u1)."""
    return dt * l(x1, u1)


def quadrature_trapezoidal(l, x1, u1, x2, dt):
    """Trapezoidal rule: dt/2 · (l(x1,u1) + l(x2,u1))."""
    return 0.5 * dt * (l(x1, u1) + l(x2, u1))


def quadrature_hermite_simpson(l, x1, u1, x2, dt, f=None):
    """Hermite-Simpson rule dt/6 · (l(x1) + 4 l(xm) + l(x2)), xm the Hermite
    midpoint when the dynamics ``f`` are given, else the arithmetic one."""
    if f is not None:
        xm = 0.5 * (x1 + x2) + (_col(dt) / 8.0) * (f(x1, u1) - f(x2, u1))
    else:
        xm = 0.5 * (x1 + x2)
    return (dt / 6.0) * (l(x1, u1) + 4.0 * l(xm, u1) + l(x2, u1))


def quadrature_hermite_simpson_lc(l, x1, u1, x2, u2, dt, f=None):
    """Hermite-Simpson cost quadrature with linear control interpolation."""
    um = 0.5 * (u1 + u2)
    if f is not None:
        xm = 0.5 * (x1 + x2) + (_col(dt) / 8.0) * (f(x1, u1) - f(x2, u2))
    else:
        xm = 0.5 * (x1 + x2)
    return (dt / 6.0) * (l(x1, u1) + 4.0 * l(xm, um) + l(x2, u2))


QUADRATURES = {
    "left_sum": quadrature_left_sum,
    "trapezoidal": quadrature_trapezoidal,
    "hermite_simpson": quadrature_hermite_simpson,
}
