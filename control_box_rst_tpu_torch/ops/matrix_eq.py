"""Matrix-equation solvers: Riccati, Lyapunov, Sylvester, controllability.

Counterpart of the JAX package's ``ops/matrix_eq.py``, with its algorithms:

  - CARE: matrix sign-function Newton iteration on the 2n×2n Hamiltonian
    (determinant-scaled, a fixed budget of 40 steps);
  - DARE: the structure-preserving doubling algorithm (30 steps);
  - Lyapunov / Sylvester: dense Kronecker linear systems (n² unknowns);
  - controllability / observability: the Kalman matrices and their rank;
  - an ordered real Schur decomposition, on the host through scipy as the
    reference has it.

The Riccati solvers and the gains are batch-first (A [..., n, n], B
[..., n, m], Q, R broadcast), the Kronecker solvers take one system. They run
where their operands are and in their dtype; the controllers and the
observer call them once, at construction. TF32 is off for the whole port
(``utils/precision.py``), so float32 products are full float32.
"""
from __future__ import annotations

import torch


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _as(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------
# Continuous algebraic Riccati equation: A'X + XA - X B R^-1 B' X + Q = 0
# --------------------------------------------------------------------------

def solve_care(A, B, Q, R, iters: int = 40) -> torch.Tensor:
    """Stabilizing CARE solution via the matrix sign function of the
    Hamiltonian M = [[A, −G], [−Q, −Aᵀ]], G = B R⁻¹ Bᵀ, with determinant
    scaling c = |det Z|^(−1/(2n)) at every step."""
    A = torch.as_tensor(A)
    B, Q, R = _as(B, A), _as(Q, A), _as(R, A)
    n = A.shape[-1]
    G = B @ torch.linalg.solve(R, _t(B))
    lead = torch.broadcast_shapes(A.shape[:-2], G.shape[:-2], Q.shape[:-2])
    A, G, Q = (a.expand(lead + a.shape[-2:]) for a in (A, G, Q))
    Z = torch.cat([torch.cat([A, -G], dim=-1), torch.cat([-Q, -_t(A)], dim=-1)], dim=-2)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        Zinv = torch.linalg.inv(Z)
        _, logdet = torch.linalg.slogdet(Z)
        c = torch.exp(-logdet / (2 * n))
        c = torch.where(torch.isfinite(c) & (c > 0), c, one)[..., None, None]
        Z = 0.5 * (c * Z + Zinv / c)
    # stable subspace: (W + I)[I; X] = 0 → [[W12], [W22+I]] X = −[[W11+I], [W21]]
    I = _eye(n, A)
    W11, W12 = Z[..., :n, :n], Z[..., :n, n:]
    W21, W22 = Z[..., n:, :n], Z[..., n:, n:]
    lhs = torch.cat([W12, W22 + I], dim=-2)
    rhs = -torch.cat([W11 + I, W21], dim=-2)
    X = torch.linalg.solve(_t(lhs) @ lhs, _t(lhs) @ rhs)
    return 0.5 * (X + _t(X))


def lqr_gain_continuous(A, B, Q, R) -> torch.Tensor:
    """K such that u = −K x stabilizes ẋ = Ax + Bu with LQR weights Q, R."""
    A = torch.as_tensor(A)
    B, R = _as(B, A), _as(R, A)
    X = solve_care(A, B, Q, R)
    return torch.linalg.solve(R, _t(B) @ X)


# --------------------------------------------------------------------------
# Discrete algebraic Riccati equation: A'XA − X − A'XB(R+B'XB)⁻¹B'XA + Q = 0
# --------------------------------------------------------------------------

def solve_dare(A, B, Q, R, iters: int = 30) -> torch.Tensor:
    """Stabilizing DARE solution via the structure-preserving doubling
    algorithm."""
    A = torch.as_tensor(A)
    B, Q, R = _as(B, A), _as(Q, A), _as(R, A)
    n = A.shape[-1]
    G = B @ torch.linalg.solve(R, _t(B))
    I = _eye(n, A)
    H = Q
    for _ in range(iters):
        W = I + G @ H
        Winv_A = torch.linalg.solve(W, A)
        A1 = A @ Winv_A
        G1 = G + A @ torch.linalg.solve(W, G @ _t(A))
        H1 = H + _t(A) @ H @ Winv_A
        A, G, H = A1, G1, H1
    return 0.5 * (H + _t(H))


def lqr_gain_discrete(A, B, Q, R) -> torch.Tensor:
    """K such that u = −K x for x⁺ = Ax + Bu."""
    A = torch.as_tensor(A)
    B, R = _as(B, A), _as(R, A)
    X = solve_dare(A, B, Q, R)
    return torch.linalg.solve(R + _t(B) @ X @ B, _t(B) @ X @ A)


# --------------------------------------------------------------------------
# Lyapunov / Sylvester (Kronecker dense solves, one system)
# --------------------------------------------------------------------------

def _kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.kron(a.contiguous(), b.contiguous())


def _vec(C: torch.Tensor) -> torch.Tensor:
    """Column-major vectorization."""
    return _t(C).reshape(-1)


def _unvec(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    return x.reshape(m, n).T


def solve_lyapunov_continuous(A, Q) -> torch.Tensor:
    """X with AᵀX + XA + Q = 0."""
    A = torch.as_tensor(A)
    Q = _as(Q, A)
    n = A.shape[0]
    I = _eye(n, A)
    L = _kron(I, A.T) + _kron(A.T, I)
    X = _unvec(torch.linalg.solve(L, -_vec(Q)), n, n)
    return 0.5 * (X + X.T)


def solve_lyapunov_discrete(A, Q) -> torch.Tensor:
    """X with AᵀXA − X + Q = 0."""
    A = torch.as_tensor(A)
    Q = _as(Q, A)
    n = A.shape[0]
    L = _kron(A.T, A.T) - _eye(n * n, A)
    X = _unvec(torch.linalg.solve(L, -_vec(Q)), n, n)
    return 0.5 * (X + X.T)


def solve_sylvester_continuous(A, B, C) -> torch.Tensor:
    """X with AX + XB + C = 0."""
    A = torch.as_tensor(A)
    B, C = _as(B, A), _as(C, A)
    n, m = A.shape[0], B.shape[0]
    L = _kron(_eye(m, A), A) + _kron(B.T, _eye(n, A))
    return _unvec(torch.linalg.solve(L, -_vec(C)), n, m)


def solve_sylvester_discrete(A, B, C) -> torch.Tensor:
    """X with AXB − X + C = 0."""
    A = torch.as_tensor(A)
    B, C = _as(B, A), _as(C, A)
    n, m = A.shape[0], B.shape[0]
    L = _kron(B.T, A) - _eye(n * m, A)
    return _unvec(torch.linalg.solve(L, -_vec(C)), n, m)


# --------------------------------------------------------------------------
# Schur decomposition (host-side utility)
# --------------------------------------------------------------------------

def schur_ordered(A, select="lhp"):
    """(Ordered) real Schur decomposition A = Q T Qᵀ on the host (numpy in,
    numpy out), as the reference provides it: select 'lhp' (stable
    continuous eigenvalues first), 'iuc' (inside the unit circle first) or
    None. No solver of the port needs it."""
    import numpy as np
    import scipy.linalg

    A = np.asarray(A.detach().cpu() if isinstance(A, torch.Tensor) else A)
    if select is None:
        T, Q = scipy.linalg.schur(A, output="real")
        return T, Q
    T, Q, _ = scipy.linalg.schur(A, output="real", sort=select)
    return T, Q


# --------------------------------------------------------------------------
# System analysis
# --------------------------------------------------------------------------

def controllability_matrix(A, B) -> torch.Tensor:
    """[B, AB, …, A^{n−1}B]."""
    A = torch.as_tensor(A)
    B = _as(B, A)
    mats, Bk = [], B
    for _ in range(A.shape[-1]):
        mats.append(Bk)
        Bk = A @ Bk
    return torch.cat(mats, dim=-1)


def _rank(M: torch.Tensor, tol: float) -> torch.Tensor:
    s = torch.linalg.svdvals(M)
    return (s > tol * s[..., :1]).sum(dim=-1)


def is_controllable(A, B, tol: float = 1e-9):
    A = torch.as_tensor(A)
    rank = _rank(controllability_matrix(A, B), tol)
    return rank == A.shape[-1], rank


def observability_matrix(A, C) -> torch.Tensor:
    """[C; CA; …; CA^{n−1}]."""
    A = torch.as_tensor(A)
    return _t(controllability_matrix(_t(A), _t(_as(C, A))))


def is_observable(A, C, tol: float = 1e-9):
    A = torch.as_tensor(A)
    rank = _rank(observability_matrix(A, C), tol)
    return rank == A.shape[-1], rank
