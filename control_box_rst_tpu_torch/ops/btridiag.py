"""Block-tridiagonal symmetric positive-definite factor/solve.

Counterpart of the JAX package's ``ops/btridiag.py``. Direct transcription
makes every KKT-like system block-tridiagonal with tiny blocks; the matrix IS
the pair (diag blocks D [..., K, nz, nz], upper-off blocks O [..., K-1, nz, nz]).

One solve is sequential over the K stages; here that is a Python loop whose
body is small dense algebra on the leading (batch) dims. This is the linear
solver of the non-fused ADMM, the oracle path and the kernels' plain
versions; on the card the production paths run the same recurrences inside
the CUDA kernels (``ops/cuda/admm_kernel.py``, ``ops/cuda/btridiag_kernel.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from control_box_rst_tpu_torch.ops.smallmat import (
    chol_small,
    mm_small_nt,
    mv_small,
    mv_small_t,
    solve_lower_mat,
    solve_lower_vec,
    solve_upperT_vec,
)


def interval_to_stage(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """Aᵀ-style scatter of interval rows into stage rows: ``top[k]`` goes to
    stage k, ``bottom[k]`` to stage k+1 ([..., N, n] each → [..., N+1, n])."""
    zero = torch.zeros_like(top[..., :1, :])
    return torch.cat([top, zero], dim=-2) + torch.cat([zero, bottom], dim=-2)


def btridiag_cholesky(D: torch.Tensor, O: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor the SPD block-tridiagonal matrix M = tridiag(Oᵀ, D, O).

    D: [..., K, nz, nz] diagonal blocks (symmetric), O: [..., K-1, nz, nz]
    upper off-diagonal blocks (M[k, k+1] = O[k]).

    Returns (Ld, Lo): Ld [..., K, nz, nz] lower-Cholesky factors of the Schur
    complements, Lo [..., K-1, nz, nz] sub-diagonal blocks of L, M = L Lᵀ.
    """
    K = D.shape[-3]
    Lk = chol_small(D[..., 0, :, :])
    Ld, Lo = [Lk], []
    for k in range(K - 1):
        # L_{k+1,k} = O_kᵀ L_k^{-T}: solve L_k X = O_k, then Lo_k = Xᵀ
        X = solve_lower_mat(Lk, O[..., k, :, :])
        Lo_k = X.transpose(-1, -2)
        S = D[..., k + 1, :, :] - mm_small_nt(Lo_k, Lo_k)
        Lk = chol_small(S)
        Ld.append(Lk)
        Lo.append(Lo_k)
    Ld = torch.stack(Ld, dim=-3)
    if Lo:
        Lo = torch.stack(Lo, dim=-3)
    else:
        Lo = O.new_zeros(O.shape)
    return Ld, Lo


def btridiag_solve(Ld: torch.Tensor, Lo: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b given the factorization from btridiag_cholesky.

    b: [..., K, nz] stage-blocked right-hand side. Returns x: [..., K, nz].
    """
    K = Ld.shape[-3]
    # forward: L z = b
    z = [solve_lower_vec(Ld[..., 0, :, :], b[..., 0, :])]
    for k in range(1, K):
        rhs = b[..., k, :] - mv_small(Lo[..., k - 1, :, :], z[-1])
        z.append(solve_lower_vec(Ld[..., k, :, :], rhs))
    # backward: Lᵀ x = z
    x = [None] * K
    x[K - 1] = solve_upperT_vec(Ld[..., K - 1, :, :], z[K - 1])
    for k in range(K - 2, -1, -1):
        rhs = z[k] - mv_small_t(Lo[..., k, :, :], x[k + 1])
        x[k] = solve_upperT_vec(Ld[..., k, :, :], rhs)
    return torch.stack(x, dim=-2)


def btridiag_matvec(D: torch.Tensor, O: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = M x for the block-tridiagonal M (testing / residuals)."""
    return mv_small(D, x) + interval_to_stage(
        mv_small(O, x[..., 1:, :]), mv_small_t(O, x[..., :-1, :])
    )


def btridiag_dense(D: torch.Tensor, O: torch.Tensor) -> torch.Tensor:
    """Materialize one (unbatched) M densely — oracle for tests."""
    K, nz, _ = D.shape
    M = D.new_zeros((K * nz, K * nz))
    for k in range(K):
        M[k * nz:(k + 1) * nz, k * nz:(k + 1) * nz] = D[k]
        if k < K - 1:
            M[k * nz:(k + 1) * nz, (k + 1) * nz:(k + 2) * nz] = O[k]
            M[(k + 1) * nz:(k + 2) * nz, k * nz:(k + 1) * nz] = O[k].T
    return M
