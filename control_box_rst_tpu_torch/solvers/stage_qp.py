"""Stage-structured ADMM QP solver (OSQP-style, block-tridiagonal direct solve).

Counterpart of the JAX package's ``solvers/stage_qp.py``.

QP canonical form (δ = step on stage variables w_k = [x;u;dt]):

  min  Σ ½ δ_kᵀ Hd_k δ_k + g_kᵀ δ_k
  s.t. J_k δ_k + K_k δ_{k+1} = -c_k          (interval rows: defects)
       rl_k - r_k ≤ G_k δ_k ≤ ru_k - r_k     (general rows)
       dlb_k ≤ δ_k ≤ dub_k                   (box rows, pins have [0,0])

Batch-first: every field of ``StageQP`` may carry leading dims ([B, N+1, …]);
fields that are the same for every lane (J, K, Hd of an LTI problem) may stay
unbatched and broadcast. Each lane carries its own ADMM state, ρ and
termination; finished lanes are frozen by a mask.

Backends (``QPConfig.backend``):
  'plain' — the non-fused ADMM: Python loops over torch ops, any float dtype,
            any device, general rows included. The oracle path. Its linear
            solver is ``QPConfig.linsolver``: 'scan' (sequential block
            Cholesky) or 'bcr' (block cyclic reduction, log₂ depth).
  'fused' — the whole solve in one call of ``ops.cuda.admm_kernel.boxqp_solve``
            (float32, ng = 0): the hand-written CUDA kernel for tensors on the
            card, its plain version for tensors on the CPU, at every batch
            size (the reference detours batches under 64 lanes through its
            plain version, which honours ``linsolver``; that detour is tile
            padding, which the port leaves out). ``linsolver`` does not
            apply. Another dtype, or general rows, raise: 'fused' never means
            the non-fused ADMM (where the reference quietly runs it for
            ng > 0).
  None    — 'plain' here; ``make_batched_solver`` picks 'fused' for a float32
            solve without general rows on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from control_box_rst_tpu_torch.ops.btridiag import interval_to_stage
from control_box_rst_tpu_torch.ops.cuda import admm_kernel
from control_box_rst_tpu_torch.ops.smallmat import mm_small_tn, mv_small, mv_small_t
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype
from control_box_rst_tpu_torch.utils.profiling import span
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class StageQP:
    """Data of one stage-structured QP (shapes: [..., N+1, …] stages,
    [..., N, …] intervals)."""

    Hd: torch.Tensor  # [..., N+1, nz, nz]
    g: torch.Tensor  # [..., N+1, nz]
    J: torch.Tensor  # [..., N, nc, nz]
    K: torch.Tensor  # [..., N, nc, nz]
    c: torch.Tensor  # [..., N, nc]
    G: torch.Tensor  # [..., N+1, ng, nz]
    gl: torch.Tensor  # [..., N+1, ng]  (= rl - r)
    gu: torch.Tensor  # [..., N+1, ng]
    dlb: torch.Tensor  # [..., N+1, nz]
    dub: torch.Tensor  # [..., N+1, nz]


@plain_dataclass
class QPConfig:
    sigma: float = 1e-6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    alpha: float = 1.6
    # None → 200 for box-only QPs, 600 with general rows (an under-solved QP
    # with general rows stalls the outer SQP loop)
    max_iter: Optional[int] = None  # total ADMM iteration budget
    # None → dtype-calibrated at solve time (f64 → 1e-8, f32 → 1e-5)
    tol: Optional[float] = None
    # ρ adaptation (OSQP §5.2): every `iters_per_round` iterations, rescale ρ
    # by sqrt(pr/dr) (clipped) and refactorize. Rounds = max_iter / round.
    iters_per_round: int = 50
    rho_min: float = 1e-4
    rho_max: float = 1e4
    # block-tridiagonal linear solver of the 'plain' backend: 'scan' (Thomas-
    # ordering block Cholesky, ops/btridiag.py) or 'bcr' (block cyclic
    # reduction, ops/btridiag_cr.py); the fused solve ignores it
    linsolver: str = "scan"
    # round execution backend: 'plain' | 'fused' | None (see module docstring)
    backend: Optional[str] = None
    # (tol_stat, tol_feas): when set (one-shot LTI path, solvers/sqp.py), the
    # fused solve ALSO exits once the exact NLP KKT residuals of the LTI QP
    # are below these
    kkt_tols: Optional[Tuple[float, float]] = None


class QPSolution(NamedTuple):
    delta: torch.Tensor  # [..., N+1, nz]
    y_dyn: torch.Tensor  # [..., N, nc]
    y_gen: torch.Tensor  # [..., N+1, ng]
    y_box: torch.Tensor  # [..., N+1, nz]
    iters: torch.Tensor  # [...] int32
    prim_res: torch.Tensor  # [...]
    dual_res: torch.Tensor  # [...]


class QPWarmStart(NamedTuple):
    delta: torch.Tensor
    y_dyn: torch.Tensor
    y_gen: torch.Tensor
    y_box: torch.Tensor


def zero_warm_start(N: int, nz: int, nc: int, ng: int, dtype=None,
                    device=None, lead=()) -> QPWarmStart:
    """``device=None`` means the card, ``dtype=None`` float32."""
    kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
    lead = tuple(lead)
    return QPWarmStart(
        delta=torch.zeros(lead + (N + 1, nz), **kw),
        y_dyn=torch.zeros(lead + (N, nc), **kw),
        y_gen=torch.zeros(lead + (N + 1, ng), **kw),
        y_box=torch.zeros(lead + (N + 1, nz), **kw),
    )


def _no_general_rows(qp: StageQP) -> None:
    """The fused solve (K1) has no general rows."""
    if qp.G.shape[-2] > 0:
        raise NotImplementedError(
            f"backend 'fused' solves box QPs only; this QP has {qp.G.shape[-2]} "
            "general rows (ng > 0): ask for backend='plain'"
        )


def _assemble_M(qp: StageQP, cfg: QPConfig, rho_eq, rho_gen, rho_box):
    """Block-tridiagonal normal matrix M = Hd + σI + Aᵀdiag(ρ)A.
    rho_eq broadcasts against [..., N, nz, nz]; rho_gen is [..., N+1, ng]
    (per general row), rho_box [..., N+1, nz]."""
    D, O = admm_kernel.assemble_M(qp.Hd, qp.J, qp.K, cfg.sigma, rho_eq, rho_box)
    if qp.G.shape[-2] > 0:
        D = D + mm_small_tn(qp.G * rho_gen[..., None], qp.G)
    return D, O


def _round_reference_fn(cfg: QPConfig, iters: int):
    """Single-ρ-round implementation matching the kernel exactly (z_d ≡ -c
    eliminated; pr/dr computed once on the final iterate). Batch-first: the
    returned function takes [..., …] operands and per-lane ρ [...]; it
    factors with ``cfg.linsolver``."""

    def _reference(Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b):
        return admm_kernel.admm_round_plain(
            Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b,
            iters, cfg.sigma, cfg.alpha, cfg.rho_eq_scale, linsolver=cfg.linsolver,
        )

    return _reference


def _make_fused_solve(cfg: QPConfig, max_iter: int, tol: float):
    """The FULL box-QP solve — every ρ-adaptation round: assemble,
    block-tridiagonal factor, `iters_per_round` ADMM iterations, recenter,
    per-lane ρ rescale, early exit. Returns (fused_solve, reference):
    ``fused_solve`` takes [B, …] operands and dispatches on their device (the
    CUDA kernel on the card, the plain version on the CPU); ``reference`` is
    the plain version for any leading dims — the kernel's oracle. The fused
    solve has one linear solver, the kernel's: ``cfg.linsolver`` does not
    apply."""
    iters = cfg.iters_per_round
    kkt = cfg.kkt_tols
    kw = dict(
        n_rounds=max(1, -(-max_iter // iters)), iters=iters, tol=float(tol),
        sigma=cfg.sigma, alpha=cfg.alpha, rho_eq_scale=cfg.rho_eq_scale,
        rho_min=cfg.rho_min, rho_max=cfg.rho_max,
        tol_stat=float(kkt[0]) if kkt is not None else 0.0,
        tol_feas=float(kkt[1]) if kkt is not None else 0.0,
    )

    def fused_solve(*args):
        return admm_kernel.boxqp_solve(*args, **kw)

    def _reference(*args):
        return admm_kernel.boxqp_solve_plain(*args, **kw)

    return fused_solve, _reference


def _expand_lead(a: torch.Tensor, lead, n_trailing: int) -> torch.Tensor:
    return a.expand(tuple(lead) + tuple(a.shape[a.dim() - n_trailing:]))


@span("stage_qp.solve")
def solve_stage_qp(
    qp: StageQP,
    cfg: QPConfig,
    warm: Optional[QPWarmStart] = None,
) -> QPSolution:
    """OSQP-style ADMM on the stage QP with ρ adaptation.

    Outer rounds: factor M with the current ρ, run `iters_per_round` fixed
    ADMM iterations, rescale ρ by √(pr/dr) (OSQP §5.2 rule) and refactorize —
    until tolerances or the iteration budget, per lane. Unscaled duals y are
    carried, so ρ changes need no dual rescaling. Three row families: the
    interval rows (ρ_eq), the general rows (ρ_eq where gl == gu, else ρ) and
    the box rows (ρ_eq on pins)."""
    dtype, dev = qp.g.dtype, qp.g.device
    Np1, nz = qp.g.shape[-2:]
    N = Np1 - 1
    nc = qp.c.shape[-1]
    ng = qp.G.shape[-2]
    tol = cfg.tol if cfg.tol is not None else (
        1e-8 if dtype == torch.float64 else 1e-5)
    max_iter = cfg.max_iter if cfg.max_iter is not None else (200 if ng == 0 else 600)
    lead = torch.broadcast_shapes(
        qp.g.shape[:-2], qp.c.shape[:-2], qp.dlb.shape[:-2], qp.Hd.shape[:-3],
        qp.J.shape[:-3], qp.G.shape[:-3], qp.gl.shape[:-2],
    )
    if cfg.backend not in (None, "plain", "fused"):
        raise KeyError(f"unknown backend {cfg.backend!r}; have ['plain', 'fused']")
    if cfg.linsolver not in admm_kernel.LINSOLVERS:
        raise KeyError(f"unknown linsolver {cfg.linsolver!r}; have {list(admm_kernel.LINSOLVERS)}")

    def A_mul(x):
        Ax_g = mv_small(qp.G, x) if ng else None
        return mv_small(qp.J, x[..., :-1, :]) + mv_small(qp.K, x[..., 1:, :]), Ax_g, x

    def At_mul(vd, vg, vb):
        out = interval_to_stage(mv_small_t(qp.J, vd), mv_small_t(qp.K, vd))
        if ng:
            out = out + mv_small_t(qp.G, vg)
        return out + vb

    if warm is None:
        warm = zero_warm_start(N, nz, nc, ng, dtype, dev, lead)
    x = _expand_lead(warm.delta, lead, 2)
    y_d = _expand_lead(warm.y_dyn, lead, 2)
    y_b = _expand_lead(warm.y_box, lead, 2)
    y_g = warm.y_gen
    z_d, z_g, z_b = A_mul(x)
    l_dyn = u_dyn = -qp.c
    z_d = torch.minimum(torch.maximum(z_d, l_dyn), u_dyn)
    z_b = torch.minimum(torch.maximum(z_b, qp.dlb), qp.dub)

    if cfg.backend == "fused":
        # the fused solve is float32 and box-only by name: a caller that
        # asked for it never gets the non-fused ADMM in its place
        _no_general_rows(qp)
        if dtype != torch.float32:
            raise TypeError(
                f"backend 'fused' takes float32, got {dtype}; ask for "
                "backend='plain' to solve in another dtype"
            )
        fused_solve, _ = _make_fused_solve(cfg, max_iter, tol)
        B = math.prod(lead)

        def flat(a, n_trailing):
            a = _expand_lead(a, lead, n_trailing)
            return a.reshape((B,) + tuple(a.shape[len(lead):]))

        rho0 = torch.full((B,), cfg.rho, dtype=dtype, device=dev)
        with span("k1.launch"):
            xo, zbo, ydo, ybo, pr, dr, it = fused_solve(
                flat(qp.Hd, 3), flat(qp.J, 3), flat(qp.K, 3), flat(qp.g, 2),
                flat(qp.c, 2), flat(qp.dlb, 2), flat(qp.dub, 2), rho0,
                flat(x, 2), flat(z_b, 2), flat(y_d, 2), flat(y_b, 2),
            )
        un = lambda a: a.reshape(tuple(lead) + tuple(a.shape[1:]))
        return QPSolution(
            delta=un(xo), y_dyn=un(ydo), y_gen=y_g, y_box=un(ybo),
            iters=un(it).to(torch.int32), prim_res=un(pr), dual_res=un(dr),
        )

    # ---- non-fused ADMM, per-lane rounds with a freeze mask ----
    box_is_eq = qp.dlb == qp.dub
    gen_is_eq = torch.isfinite(qp.gl) & (qp.gl == qp.gu)
    n_rounds = max(1, -(-max_iter // cfg.iters_per_round))
    a = cfg.alpha
    rho = torch.full(lead, cfg.rho, dtype=dtype, device=dev)
    it = torch.zeros(lead, dtype=torch.int32, device=dev)
    pr = torch.full(lead, math.inf, dtype=dtype, device=dev)
    dr = torch.full(lead, math.inf, dtype=dtype, device=dev)
    x, z_d, z_b, y_d, y_b = (
        _expand_lead(t, lead, 2) for t in (x, z_d, z_b, y_d, y_b)
    )
    if ng:
        z_g = _expand_lead(torch.minimum(torch.maximum(z_g, qp.gl), qp.gu), lead, 2)
        y_g = _expand_lead(y_g, lead, 2)

    def family(Ax, z, y, rho_f, lo, hi):
        v = a * Ax + (1 - a) * z
        z_new = torch.minimum(torch.maximum(v + y / rho_f, lo), hi)
        y_new = y + rho_f * (v - z_new)
        return z_new, y_new

    for _ in range(n_rounds):
        active = (pr > tol) | (dr > tol)
        if not bool(active.any()):
            break
        rho_eq3 = (rho * cfg.rho_eq_scale)[..., None, None]
        rho3 = rho[..., None, None]
        rho_box = torch.where(box_is_eq, rho_eq3, rho3).to(dtype)
        rho_gen = torch.where(gen_is_eq, rho_eq3, rho3).to(dtype) if ng else None
        D, O = _assemble_M(qp, cfg, rho_eq3[..., None], rho_gen, rho_box)
        solve_M = admm_kernel.factor_solver(D, O, cfg.linsolver)
        xn, zdn, zgn, zbn, ydn, ygn, ybn = x, z_d, z_g, z_b, y_d, y_g, y_b
        for _ in range(cfg.iters_per_round):
            rhs = cfg.sigma * xn - qp.g + At_mul(
                rho_eq3 * zdn - ydn, rho_gen * zgn - ygn if ng else None,
                rho_box * zbn - ybn,
            )
            x_t = solve_M(rhs)
            Ax_d, Ax_g, Ax_b = A_mul(x_t)
            xn = a * x_t + (1 - a) * xn
            zd2, ydn = family(Ax_d, zdn, ydn, rho_eq3, l_dyn, u_dyn)
            if ng:
                zg2, ygn = family(Ax_g, zgn, ygn, rho_gen, qp.gl, qp.gu)
            zb2, ybn = family(Ax_b, zbn, ybn, rho_box, qp.dlb, qp.dub)
            # residuals (OSQP §3.4)
            pr_n = torch.maximum(
                (Ax_d - zd2).abs().amax(dim=(-2, -1)),
                (Ax_b - zb2).abs().amax(dim=(-2, -1)),
            )
            if ng:
                pr_n = torch.maximum(pr_n, (Ax_g - zg2).abs().amax(dim=(-2, -1)))
            dz = At_mul(rho_eq3 * (zd2 - zdn), rho_gen * (zg2 - zgn) if ng else None,
                        rho_box * (zb2 - zbn))
            dr_n = dz.abs().amax(dim=(-2, -1))
            zdn, zbn = zd2, zb2
            if ng:
                zgn = zg2
        # ρ adaptation: balance primal vs dual residual (OSQP §5.2)
        scale = torch.sqrt(pr_n / torch.clamp(dr_n, min=1e-30))
        rho_n = torch.clamp(
            rho * torch.clamp(scale, 0.1, 10.0), cfg.rho_min, cfg.rho_max
        )
        conv = (pr_n < tol) & (dr_n < tol)
        rho_n = torch.where(conv, rho, rho_n)
        a2 = active[..., None, None]
        x = torch.where(a2, xn, x)
        z_d = torch.where(a2, zdn, z_d)
        z_b = torch.where(a2, zbn, z_b)
        y_d = torch.where(a2, ydn, y_d)
        y_b = torch.where(a2, ybn, y_b)
        if ng:
            z_g = torch.where(a2, zgn, z_g)
            y_g = torch.where(a2, ygn, y_g)
        rho = torch.where(active, rho_n, rho)
        pr = torch.where(active, pr_n, pr)
        dr = torch.where(active, dr_n, dr)
        it = torch.where(active, it + cfg.iters_per_round, it)
    return QPSolution(
        delta=x, y_dyn=y_d, y_gen=y_g, y_box=y_b, iters=it,
        prim_res=pr, dual_res=dr,
    )


def dense_qp_oracle(qp: StageQP, cfg: QPConfig = None):
    """Dense oracle for one unbatched QP — FOR TESTS ONLY: materializes the
    full KKT system and solves the *equality-only* QP densely: interval rows,
    general rows with gl == gu (finite) and pinned box rows. Inequality
    general rows and box inequalities are ignored, so compare only on
    problems where they are inactive. Returns (δ [N+1, nz], y_dyn [N, nc])."""
    Np1, nz = qp.g.shape
    N = Np1 - 1
    nc = qp.c.shape[1]
    n = Np1 * nz
    dt = dict(dtype=qp.g.dtype, device=qp.g.device)
    H = torch.zeros((n, n), **dt)
    for k in range(Np1):
        H[k * nz:(k + 1) * nz, k * nz:(k + 1) * nz] = qp.Hd[k]
    g = qp.g.reshape(-1)
    A = torch.zeros((N * nc, n), **dt)
    for k in range(N):
        A[k * nc:(k + 1) * nc, k * nz:(k + 1) * nz] = qp.J[k]
        A[k * nc:(k + 1) * nc, (k + 1) * nz:(k + 2) * nz] = qp.K[k]
    b = (-qp.c).reshape(-1)
    eq_rows = [(k, i) for k in range(Np1) for i in range(qp.G.shape[1])
               if bool(torch.isfinite(qp.gl[k, i])) and bool(qp.gl[k, i] == qp.gu[k, i])]
    if eq_rows:
        Ag = torch.zeros((len(eq_rows), n), **dt)
        for r, (k, i) in enumerate(eq_rows):
            Ag[r, k * nz:(k + 1) * nz] = qp.G[k, i]
        A = torch.cat([A, Ag])
        b = torch.cat([b, torch.stack([qp.gl[k, i] for k, i in eq_rows])])
    pin = (qp.dlb == qp.dub).reshape(-1)
    H = H + 1e10 * torch.diag(pin.to(qp.g.dtype))
    m = A.shape[0]
    KKT = torch.zeros((n + m, n + m), **dt)
    KKT[:n, :n] = H + 1e-12 * torch.eye(n, **dt)
    KKT[:n, n:] = A.T
    KKT[n:, :n] = A
    sol = torch.linalg.solve(KKT, torch.cat([-g, b]))
    return sol[:n].reshape(Np1, nz), sol[n:n + N * nc].reshape(N, nc)
