"""Plain reference solver of ``problem.Problem``: single shooting, projected
Gauss-Newton with an Armijo search along the projection arc (Bertsekas'
projected Newton method on the box of the controls).

The states are eliminated by the rollout x_{k+1} = Phi(x_k, u_k); the
Gauss-Newton matrix and the gradient are sums of products of the rollout's
sensitivities dx_k/dU, which makes the method exact Newton on a linear
system (a handful of iterations) and linearly convergent on a nonlinear one.
It shares no code and no data with the program: it starts from U = 0 and
reads only the problem and the initial states. Every product goes through
``torch.matmul`` / ``einsum``, so the same code in float32 with TF32 switched
on is the comparison's control (``precision``).
"""
from __future__ import annotations

import contextlib

import torch

from perfbench.reference.problem import Problem

# projected-gradient tolerance and iteration cap per dtype (float32 is the
# control's, which TF32's rounding keeps from the float64 tolerance)
TOL = {torch.float64: 1e-11, torch.float32: 1e-6}
MAX_ITER = {torch.float64: 400, torch.float32: 60}
ARMIJO = 1e-4
HALVINGS = 50


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products in TF32 (``tf32=True``) or in full float32 inside the
    block; the previous settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _quad(x, M):
    return ((x @ M) * x).sum(-1)


def objective(p: Problem, x0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """J(U) of every lane: x0 [B, nx], U [B, N, nu] -> [B]."""
    x, J = x0, torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
    for k in range(p.N):
        u = U[:, k]
        J = J + _quad(x, p.Q) + _quad(u, p.R)
        x = p.step(x, u)
    return J + _quad(x, p.Qf)


def _linearised(p: Problem, x0: torch.Tensor, U: torch.Tensor):
    """Objective, gradient [B, n] and Gauss-Newton matrix [B, n, n] at U
    (n = N nu), from the rollout's sensitivities S_k = dx_k / dU."""
    B, N, nu, nx = x0.shape[0], p.N, p.nu, p.nx
    n = N * nu
    jac = torch.func.vmap(torch.func.jacrev(p.step, argnums=(0, 1)))
    x = x0
    S = torch.zeros((B, nx, n), dtype=x0.dtype, device=x0.device)
    xs, Ss = [], []
    for k in range(N):
        u = U[:, k]
        xs.append(x)
        Ss.append(S)
        A, Bk = jac(x, u)
        S = A @ S
        S[:, :, k * nu:(k + 1) * nu] += Bk
        x = p.step(x, u)
    X, SS = torch.stack(xs, 1), torch.stack(Ss, 1)        # [B, N, nx], [B, N, nx, n]
    Uf = U.reshape(B, n)
    Rb = torch.block_diag(*([p.R] * N))
    J = _quad(X, p.Q).sum(-1) + _quad(Uf, Rb) + _quad(x, p.Qf)
    g = 2.0 * (torch.einsum("bkin,ij,bkj->bn", SS, p.Q, X) + Uf @ Rb
               + torch.einsum("bin,ij,bj->bn", S, p.Qf, x))
    H = 2.0 * (torch.einsum("bkin,ij,bkjm->bnm", SS, p.Q, SS) + Rb
               + torch.einsum("bin,ij,bjm->bnm", S, p.Qf, S))
    return J, g, H


def solve(p: Problem, x0: torch.Tensor, U0=None, max_iter: int = None):
    """Optimal U [B, N, nu] of every lane from x0 [B, nx], in x0's dtype and
    on its device; U0 (default 0) is the start. Returns (U, converged [B])."""
    B, N, nu = x0.shape[0], p.N, p.nu
    lo, hi, tol = p.u_lo, p.u_hi, TOL[x0.dtype]
    max_iter = max_iter or MAX_ITER[x0.dtype]
    U = (torch.zeros((B, N, nu), dtype=x0.dtype, device=x0.device) if U0 is None
         else U0.clamp(lo, hi).to(x0.dtype))
    stalled = torch.zeros(B, dtype=torch.bool, device=x0.device)
    for _ in range(max_iter):
        J, g, H = _linearised(p, x0, U)
        u = U.reshape(B, N * nu)
        res = (u - (u - g).clamp(lo, hi)).abs().amax(-1)
        done = res <= tol
        # a lane whose search found no decrease stops there (rounding)
        if bool((done | stalled).all()):
            break
        eps = res.clamp(max=1e-3)[:, None]
        act = ((u <= lo + eps) & (g > 0)) | ((u >= hi - eps) & (g < 0))
        free = ~act
        Hm = torch.where(free[:, :, None] & free[:, None, :], H, torch.zeros_like(H))
        Hm = Hm + torch.diag_embed(act.to(H.dtype))
        L, info = torch.linalg.cholesky_ex(Hm)
        d_free = torch.cholesky_solve(torch.where(free, -g, 0.0)[..., None], L)[..., 0]
        d = torch.where(free, d_free, -g / torch.diagonal(H, dim1=-2, dim2=-1))
        d = torch.where((info == 0)[:, None], d, -g)
        # Armijo along the projection arc, lane by lane
        taken = done | stalled
        alpha = torch.ones(B, dtype=x0.dtype, device=x0.device)
        u_new = u.clone()
        for _ in range(HALVINGS):
            ut = (u + alpha[:, None] * d).clamp(lo, hi)
            # a change below the objective's own rounding counts as no increase
            slack = 8.0 * torch.finfo(J.dtype).eps * J.abs()
            ok = objective(p, x0, ut.reshape(B, N, nu)) <= J + ARMIJO * (g * (ut - u)).sum(-1) + slack
            ok = ok & ~taken
            u_new = torch.where(ok[:, None], ut, u_new)
            taken = taken | ok
            if bool(taken.all()):
                break
            alpha = torch.where(taken, alpha, 0.5 * alpha)
        stalled = stalled | ~taken
        U = u_new.reshape(B, N, nu)
    return U, done


def closed_loop(p: Problem, x0: torch.Tensor, steps: int):
    """The MPC closed loop of every lane: at each step the optimal plan from
    the state, its first control held over dt on the plant. Returns (u [B,
    steps, nu], x [B, steps + 1, nx], converged [B, steps])."""
    x, U = x0, None
    us, xs, oks = [], [x0], []
    for _ in range(steps):
        if U is not None:  # the previous plan, shifted, is the start
            U = torch.cat([U[:, 1:], U[:, -1:]], dim=1)
        U, ok = solve(p, x, U)
        u = U[:, 0]
        x = p.plant_step(x, u)
        us.append(u)
        xs.append(x)
        oks.append(ok)
    return torch.stack(us, 1), torch.stack(xs, 1), torch.stack(oks, 1)
