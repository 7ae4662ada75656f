"""Block cyclic reduction: log-depth factor/solve for SPD block-tridiagonal
systems.

Counterpart of the JAX package's ``ops/btridiag_cr.py``: the same
elimination as ``ops/btridiag.py`` (block Cholesky under an odd-even
permutation, so SPD is preserved), reordered into ⌈log₂ K⌉ levels whose work
is one batched product over all remaining stages. Batch-first: every
function takes [..., K, nz, nz] / [..., K, nz] operands with any leading
dims. Plain PyTorch; no kernel of its own (the linear solver
``linsolver='bcr'`` of the non-fused ADMM).

Layout: M = tridiag(Oᵀ, D, O) with D [..., K, nz, nz] symmetric diagonal
blocks and O [..., K-1, nz, nz] upper off-diagonals (M[k, k+1] = O[k]). K is
padded to 2^m + 1 with identity/zero blocks (decoupled dummy unknowns).

One level (evens e = 2j keep, odds o = 2j+1 eliminated):
    α_{j+1} = O[2j+1]ᵀ B⁻¹[2j+1],   γ_j = O[2j] B⁻¹[2j+1]
    D'_{j+1} −= α_{j+1} O[2j+1],    D'_j −= γ_j O[2j]ᵀ
    O'_j = −γ_j O[2j+1]
    b'_{j+1} −= α_{j+1} b[2j+1],    b'_j −= γ_j b[2j+1]
Back substitution:
    x[2j+1] = B⁻¹[2j+1] (b[2j+1] − O[2j]ᵀ x[2j] − O[2j+1] x[2j+2])
Reduction stops at K = 2; the remaining 2-block system is solved densely.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from control_box_rst_tpu_torch.ops.smallmat import (
    inv_spd_small,
    mm_small,
    mm_small_nt,
    mm_small_tn,
    mv_small,
    mv_small_t,
)


class BCRFactors(NamedTuple):
    # per level: (Binv, alpha, gamma, OL, OR), each [..., n_odd, nz, nz]
    levels: Tuple
    root_inv: torch.Tensor  # [..., 2nz, 2nz] (or [..., nz, nz] when K == 1)
    K: int                  # original (unpadded) stage count


def _pad_pow2p1(D: torch.Tensor, O: torch.Tensor):
    """D, O padded to Kp = 2^m + 1 stages with identity / zero blocks."""
    K = D.shape[-3]
    m = max(1, math.ceil(math.log2(max(K - 1, 1))))
    Kp = (1 << m) + 1
    if Kp == K:
        return D, O
    nz = D.shape[-1]
    lead = D.shape[:-3]
    eye = torch.eye(nz, dtype=D.dtype, device=D.device).expand(lead + (Kp - K, nz, nz))
    Dp = torch.cat([D, eye], dim=-3)
    Op = torch.cat([O, O.new_zeros(lead + (Kp - K, nz, nz))], dim=-3)
    return Dp, Op


def bcr_factor(D: torch.Tensor, O: torch.Tensor) -> BCRFactors:
    """Per-level elimination coefficients of M = tridiag(Oᵀ, D, O).
    D: [..., K, nz, nz] SPD diagonal blocks, O: [..., K-1, nz, nz]."""
    K_orig = D.shape[-3]
    if K_orig == 1:
        return BCRFactors(levels=(), root_inv=inv_spd_small(D[..., 0, :, :]), K=1)
    D, O = _pad_pow2p1(D, O)
    levels = []
    while D.shape[-3] > 2:
        Binv = inv_spd_small(D[..., 1::2, :, :])  # [..., n_odd, nz, nz]
        OL = O[..., 0::2, :, :]                   # O[2j]
        OR = O[..., 1::2, :, :]                   # O[2j+1]
        alpha = mm_small_tn(OR, Binv)             # α_{j+1}
        gamma = mm_small(OL, Binv)                # γ_j
        zero = torch.zeros_like(alpha[..., :1, :, :])
        D_new = (D[..., 0::2, :, :]
                 + torch.cat([zero, -mm_small(alpha, OR)], dim=-3)
                 + torch.cat([-mm_small_nt(gamma, OL), zero], dim=-3))
        O_new = -mm_small(gamma, OR)
        levels.append((Binv, alpha, gamma, OL, OR))
        D, O = D_new, O_new
    # 2-block root: [[D0, O0], [O0ᵀ, D1]]
    top = torch.cat([D[..., 0, :, :], O[..., 0, :, :]], dim=-1)
    bot = torch.cat([O[..., 0, :, :].transpose(-1, -2), D[..., 1, :, :]], dim=-1)
    root_inv = inv_spd_small(torch.cat([top, bot], dim=-2))
    return BCRFactors(levels=tuple(levels), root_inv=root_inv, K=K_orig)


def bcr_solve(fac: BCRFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b with precomputed factors. b: [..., K, nz] → x."""
    K, nz = fac.K, b.shape[-1]
    if K == 1:
        return mv_small(fac.root_inv, b[..., 0, :])[..., None, :]
    Kp = (1 << len(fac.levels)) + 1  # the padded size the factor started from
    if Kp != K:
        b = torch.cat([b, b.new_zeros(b.shape[:-2] + (Kp - K, nz))], dim=-2)
    # forward reduction
    b_odds = []
    for (Binv, alpha, gamma, OL, OR) in fac.levels:
        b_odd = b[..., 1::2, :]
        zero = torch.zeros_like(b_odd[..., :1, :])
        b = (b[..., 0::2, :]
             + torch.cat([zero, -mv_small(alpha, b_odd)], dim=-2)
             + torch.cat([-mv_small(gamma, b_odd), zero], dim=-2))
        b_odds.append(b_odd)
    # 2-block root
    lead = b.shape[:-2]
    x = mv_small(fac.root_inv, b.reshape(lead + (2 * nz,))).reshape(lead + (2, nz))
    # back substitution
    for (Binv, alpha, gamma, OL, OR), b_odd in zip(reversed(fac.levels), reversed(b_odds)):
        rhs = b_odd - mv_small_t(OL, x[..., :-1, :]) - mv_small(OR, x[..., 1:, :])
        x_odd = mv_small(Binv, rhs)
        n_odd = x_odd.shape[-2]
        pairs = torch.stack([x[..., :-1, :], x_odd], dim=-2)  # [..., n_odd, 2, nz]
        x = torch.cat([pairs.reshape(x.shape[:-2] + (2 * n_odd, nz)), x[..., -1:, :]], dim=-2)
    return x[..., :K, :]
