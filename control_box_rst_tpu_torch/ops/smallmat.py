"""Unrolled small-matrix linear algebra.

Counterpart of the JAX package's ``ops/smallmat.py``. The KKT blocks of
direct transcription are tiny (nz = nx+nu+1 ≈ 4-12), so the factorization and
the substitutions are unrolled over the static block size and every operation
is an elementwise op on the leading (batch) dims; the tiny products are
broadcast-multiply-sum. These routines sit outside any kernel: they serve the
non-fused ADMM, the oracle path and the kernels' plain versions.

Shapes: all functions take [..., n, n] / [..., n] with arbitrary leading dims.
"""
from __future__ import annotations

import torch


def chol_small(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor L (lower) of SPD A, unrolled over the static n."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        d = torch.sqrt(d)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [
        torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
        for i in range(n)
    ]
    return torch.stack(rows, dim=-2)


def solve_lower_vec(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b (L lower-triangular), b: [..., n]."""
    n = L.shape[-1]
    xs = []
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * xs[k]
        xs.append(s / L[..., i, i])
    return torch.stack(xs, dim=-1)


def solve_upperT_vec(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve Lᵀ x = b (L lower-triangular), b: [..., n]."""
    n = L.shape[-1]
    xs = [None] * n
    for i in reversed(range(n)):
        s = b[..., i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * xs[k]
        xs[i] = s / L[..., i, i]
    return torch.stack(xs, dim=-1)


def solve_lower_mat(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L X = B with B: [..., n, m] (row-wise substitution)."""
    n = L.shape[-1]
    rows = []
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k][..., None] * rows[k]
        rows.append(s / L[..., i, i][..., None])
    return torch.stack(rows, dim=-2)


def chol_solve_vec(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) x = b."""
    return solve_upperT_vec(L, solve_lower_vec(L, b))


# -- tiny-contraction products as broadcast-multiply-sum --------------------

def mm_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for tiny trailing dims: [..., m, k] x [..., k, n] -> [..., m, n]."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def mm_small_tn(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Aᵀ @ B: [..., k, m] x [..., k, n] -> [..., m, n] (contract first dim)."""
    return (A[..., :, :, None] * B[..., :, None, :]).sum(dim=-3)


def mm_small_nt(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ Bᵀ: [..., m, k] x [..., n, k] -> [..., m, n]."""
    return (A[..., :, None, :] * B[..., None, :, :]).sum(dim=-1)


def mv_small(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x: [..., m, k] x [..., k] -> [..., m]."""
    return (A * x[..., None, :]).sum(dim=-1)


def mv_small_t(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Aᵀ @ x: [..., k, m] x [..., k] -> [..., m]."""
    return (A * x[..., :, None]).sum(dim=-2)


def inv_spd_small(A: torch.Tensor) -> torch.Tensor:
    """Inverse of small SPD A via the unrolled Cholesky factor:
    A⁻¹ = L⁻ᵀ L⁻¹ = XᵀX with X = L⁻¹."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    X = solve_lower_mat(chol_small(A), eye)
    return mm_small_tn(X, X)
