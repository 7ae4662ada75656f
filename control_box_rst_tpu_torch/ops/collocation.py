"""Finite-difference collocation defects.

Counterpart of the JAX package's ``ops/collocation.py``; only the schemes the
ported configurations use are present. Sign convention as there:
defect = f(·) − (x2 − x1)/dt. All operands broadcast over leading dims
(``dt`` is [...], states are [..., nx]).
"""
from __future__ import annotations


def forward_diff_defect(f, x1, u1, x2, dt):
    """Forward Euler defect: f(x1,u1) − (x2−x1)/dt."""
    return f(x1, u1) - (x2 - x1) / dt[..., None]


def crank_nicolson_defect(f, x1, u1, x2, dt):
    """Crank-Nicolson defect: 0.5(f(x1,u1)+f(x2,u1)) − (x2−x1)/dt."""
    return 0.5 * (f(x1, u1) + f(x2, u1)) - (x2 - x1) / dt[..., None]


FD_COLLOCATIONS = {
    "forward": forward_diff_defect,
    "crank_nicolson": crank_nicolson_defect,
}

# schemes of the JAX package that a later slice of the port brings over
_NOT_YET_PORTED = (
    "backward", "midpoint",
    "hermite_simpson", "hermite_simpson_lc", "hermite_simpson_unc",
)


def get_fd_collocation(name: str):
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"FD collocation {name!r} is not ported yet (other-grids slice); "
            f"have {sorted(FD_COLLOCATIONS)}"
        )
    if name not in FD_COLLOCATIONS:
        raise KeyError(f"unknown FD collocation {name!r}; have {sorted(FD_COLLOCATIONS)}")
    return FD_COLLOCATIONS[name]
