"""Primal-dual interior-point solver for stage NLPs, batch-first.

Counterpart of the JAX package's ``solvers/ip.py`` (the IPOPT-role backend).
The problem is the canonical stage NLP

  min  f(W)
  s.t. c_k(w_k, w_{k+1}) = 0          (interval rows: defects + ties)
       rl ≤ r_k(w_k) ≤ ru             (general rows → slacks s, barrier)
       lb ≤ W ≤ ub                    (box rows → barrier)

Two-sided general rows become per-stage slacks with log barriers on both
sides; the slack and bound-dual blocks are eliminated analytically, so the
Hessian block H_hat = H + Σ_w + GᵀΣ_sG is block-diagonal per stage, and the
interval rows are condensed by the Schur complement S = A H_hat⁻¹ Aᵀ: SPD
block-tridiagonal with nc×nc blocks. Its factor and solve is one call of
``ops/cuda/btridiag_kernel.btridiag_factor_solve`` per iteration — the
hand-written kernel for tensors on the card (K4, or K3 with
``inplace=False``), its plain version on the CPU. Monotone μ reduction
(IPOPT's κ_μ/θ_μ schedule), the fraction-to-boundary rule and a backtracking
line search on the barrier ℓ1 merit, every candidate step evaluated in one
batched call.

Batch-first where the reference is vmapped: ``ip_solve`` takes a batched
``ocp.bc.x0`` / ``traj0`` directly. Every lane has its own μ, merit weight ν,
iteration count, ``done`` / ``diverged`` flags and status; the loop runs in
lock step while any lane's condition holds, and a lane whose condition is
false is frozen whole (its counter too), as a vmapped ``while_loop`` freezes
it. Equality general rows (rl == ru) and box rows with lb == ub on a free
variable are relaxed by a dtype-scaled ε, so every slack keeps an interior.

Layer spans and counters (``utils/profiling.py``; they record only while a
profiler session records): ``ip.solve`` around the whole solve, ``ip.newton``
(the condensed Hessian, the Schur system and the back-substitution) with
``k4.launch`` (the block-tridiagonal solve's call) inside it,
``ip.line_search`` (the merits and the Armijo choice), ``ip.wait`` (the loop
test's one wait on the device); ``ip.lockstep_iters`` per loop trip, and at
return ``ip.lane_iters`` (Σ of the lanes' own iterations) and
``ip.lane_slots`` (lanes × lock-step iterations).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from control_box_rst_tpu_torch.core.types import SolverStatus
from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.ocp.transcribe import TranscribedOCP
from control_box_rst_tpu_torch.ops.btridiag import interval_to_stage
from control_box_rst_tpu_torch.ops.cuda.btridiag_kernel import btridiag_factor_solve
from control_box_rst_tpu_torch.ops.smallmat import (
    inv_spd_small,
    mm_small,
    mm_small_nt,
    mv_small,
    mv_small_t,
)
from control_box_rst_tpu_torch.solvers.sqp import _psd_clamp
from control_box_rst_tpu_torch.utils.precision import check_precision_policy
from control_box_rst_tpu_torch.utils.profiling import count, span
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class IPConfig:
    """Interior-point options (defaults follow IPOPT's where they exist)."""

    max_iter: int = 60
    mu_init: float = 1e-1
    # μ schedule: μ⁺ = max(tol/10, min(κ_μ·μ, μ^θ_μ))
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    kappa_eps: float = 10.0  # inner tol = κ_ε·μ
    tau_min: float = 0.99  # fraction-to-boundary floor
    # None → dtype-calibrated at solve time: f64 → 1e-8, f32 → 5e-4
    tol: Optional[float] = None
    # regularization of the condensed system; None → f64 (1e-8, 1e-10),
    # f32 (1e-6, 1e-7)
    reg_primal: Optional[float] = None
    reg_dual: Optional[float] = None
    ls_candidates: int = 8
    ls_c1: float = 1e-4
    merit_nu_init: float = 10.0
    psd_clamp: bool = False
    # κ_Σ dual-consistency clip
    kappa_sigma: float = 1e10
    # initial-point push-off-bounds factor (IPOPT κ₁ = κ₂ = 0.01)
    bound_push: float = 1e-2


class IPResult(NamedTuple):
    traj: Trajectory
    W: torch.Tensor
    S: torch.Tensor  # general-row slacks [..., N+1, ng]
    y_dyn: torch.Tensor  # [..., N, nc]
    y_gen: torch.Tensor  # [..., N+1, ng]
    z_lw: torch.Tensor  # bound duals on W (lower / upper) [..., N+1, nz]
    z_uw: torch.Tensor
    iterations: torch.Tensor
    objective: torch.Tensor
    stat_res: torch.Tensor
    feas_res: torch.Tensor
    comp_res: torch.Tensor
    mu: torch.Tensor
    status: torch.Tensor  # SolverStatus int32


class _State(NamedTuple):
    W: torch.Tensor
    S: torch.Tensor
    y: torch.Tensor
    yg: torch.Tensor
    z_lw: torch.Tensor
    z_uw: torch.Tensor
    z_ls: torch.Tensor
    z_us: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    it: torch.Tensor
    stat: torch.Tensor
    feas: torch.Tensor
    comp: torch.Tensor
    done: torch.Tensor
    diverged: torch.Tensor


def _lanes(m: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A per-lane [B] tensor shaped to broadcast against ``a`` [B, ...]."""
    return m.reshape(m.shape + (1,) * (a.dim() - m.dim()))


def _amax2(a: torch.Tensor) -> torch.Tensor:
    """Per-lane max over the trailing [stage, entry] dims."""
    return a.amax(dim=(-2, -1))


def _sum2(a: torch.Tensor) -> torch.Tensor:
    return a.sum(dim=(-2, -1))


@span("ip.solve")
def ip_solve(
    ocp: TranscribedOCP,
    traj0: Trajectory,
    cfg: Optional[IPConfig] = None,
    inplace: bool = True,
) -> IPResult:
    """Solve the transcribed OCP by a primal-dual interior-point method, for
    one problem or a batch (``ocp.bc.x0`` [..., nx] and/or ``traj0`` with
    leading dims); every field of the result carries those leading dims.
    ``inplace`` is handed to ``btridiag_factor_solve`` (which of its kernels
    solves the Schur system on the card); the answer does not depend on it."""
    check_precision_policy()
    cfg = cfg or IPConfig()
    N, nz, nc, ng = ocp.N, ocp.nz, ocp.nc, ocp.ng

    traj0 = ocp.apply_boundary(traj0)
    W_init = ocp.with_mask_lanes(ocp.pack(traj0))
    lead = tuple(W_init.shape[:-2])
    if ocp.per_lane_mask:
        ocp = ocp.replace(stage_mask=ocp.stage_mask.expand(lead + (N,)).reshape(-1, N))
    W_init = W_init.reshape((-1,) + W_init.shape[-2:])
    B = W_init.shape[0]
    dtype, dev = W_init.dtype, W_init.device
    kw = dict(dtype=dtype, device=dev)
    f64 = dtype == torch.float64

    tol = cfg.tol if cfg.tol is not None else (1e-8 if f64 else 5e-4)
    reg_p = cfg.reg_primal if cfg.reg_primal is not None else (1e-8 if f64 else 1e-6)
    reg_d = cfg.reg_dual if cfg.reg_dual is not None else (1e-10 if f64 else 1e-7)
    eps_relax = 1e-8 if f64 else 1e-5  # bound relaxation of rl == ru rows
    tiny = 1e-30

    pin = ocp.fixed_mask().to(dtype)
    free = 1.0 - pin
    lb, ub = (b.to(dtype) for b in ocp.w_bounds())
    # finite-bound masks on FREE variables only (pins never get barriers)
    mwL = (free > 0) & torch.isfinite(lb)
    mwU = (free > 0) & torch.isfinite(ub)
    # box rows with lb == ub on a free variable: relax symmetrically
    box_eq = mwL & mwU & (lb == ub)
    lb = torch.where(box_eq, lb - eps_relax, lb)
    ub = torch.where(box_eq, ub + eps_relax, ub)

    # slack bounds of the general rows (the same for every lane and iterate)
    if ng:
        rl, ru = (b.to(dtype) for b in ocp.general_row_bounds())
    else:
        rl = ru = torch.zeros((N + 1, 0), **kw)
    msL, msU = torch.isfinite(rl), torch.isfinite(ru)
    gen_eq = msL & msU & (rl == ru)
    sl = torch.where(gen_eq, rl - eps_relax, rl)
    su = torch.where(gen_eq, ru + eps_relax, ru)
    # rows with no finite bound (padding) get unit Σ_s so the elimination
    # stays regular; their multipliers remain 0
    s_inactive = (~msL) & (~msU)

    one = torch.ones((), **kw)

    def where0(mask, v):
        return torch.where(mask, v, torch.zeros_like(v))

    def push_inside(v, lo, hi, mL, mU):
        """Push v off its bounds (IPOPT's initial point)."""
        both = mL & mU
        width = torch.where(both, hi - lo, one)
        pl_ = torch.minimum(
            cfg.bound_push * torch.clamp(where0(mL, lo).abs(), min=1.0), 0.45 * width)
        pu_ = torch.minimum(
            cfg.bound_push * torch.clamp(where0(mU, hi).abs(), min=1.0), 0.45 * width)
        v = torch.where(mL, torch.maximum(v, lo + pl_), v)
        return torch.where(mU, torch.minimum(v, hi - pu_), v)

    W0 = push_inside(W_init, lb, ub, mwL, mwU)
    W0 = torch.where(pin > 0, W_init, W0)
    if ng:
        S0 = push_inside(ocp.general_rows(W0)[0], sl, su, msL, msU)
    else:
        S0 = torch.zeros((B, N + 1, 0), **kw)

    mu0 = torch.full((B,), cfg.mu_init, **kw)

    def z_init(v, lo, hi, mL, mU, mu):
        m = _lanes(mu, v)
        zl = where0(mL, m / torch.clamp(v - lo, min=1e-8))
        zu = where0(mU, m / torch.clamp(hi - v, min=1e-8))
        return torch.clamp(zl, 0.0, 1e8), torch.clamp(zu, 0.0, 1e8)

    z_lw0, z_uw0 = z_init(W0, lb, ub, mwL, mwU, mu0)
    z_ls0, z_us0 = z_init(S0, sl, su, msL, msU, mu0)

    eye_nz = torch.eye(nz, **kw)
    eye_nc = torch.eye(nc, **kw)
    backtracks = 0.5 ** torch.arange(cfg.ls_candidates, **kw)

    def safe_dist(v, lo, hi, mL, mU):
        """Distances to the bounds, 1.0 where a bound is absent (the mask is
        applied downstream — no inf / NaN arithmetic)."""
        return torch.where(mL, v - lo, one), torch.where(mU, hi - v, one)

    def log_sum(d, mask):
        return _sum2(where0(mask, torch.log(torch.clamp(d, min=tiny))))

    def barrier_merit(W, S, mu, nu):
        """φ_μ = f − μ·Σ logs + ν·(‖c‖₁ + ‖r − s‖₁) per lane; returns (φ, infeas).
        W, S may carry a leading candidate dim before the lanes."""
        f = ocp.objective_from_W(W)
        dLw, dUw = safe_dist(W, lb, ub, mwL, mwU)
        logs = log_sum(dLw, mwL) + log_sum(dUw, mwU)
        infeas = _sum2(ocp.interval_residuals(W).abs())
        if ng:
            dLs, dUs = safe_dist(S, sl, su, msL, msU)
            logs = logs + log_sum(dLs, msL) + log_sum(dUs, msU)
            infeas = infeas + _sum2((ocp.general_rows(W)[0] - S).abs())
        return f - mu * logs + nu * infeas, infeas

    # constant structure of an LTI problem (J, K) and of a quadratic cost on
    # it (H), evaluated once from the first lane: the same for every lane
    clamp = bool(cfg.psd_clamp) or not getattr(ocp.cost, "convex", True)

    def mask_H(Hd):
        if clamp:
            Hd = _psd_clamp(Hd)
        return Hd * free[:, None, :] * free[:, :, None]

    hoist_JK = ocp.lti_structure and not ocp.per_lane_mask
    hoist_H = ocp.constant_hessian and not ocp.per_lane_mask
    if hoist_JK:
        J_c, K_c, _ = ocp.interval_jacobians(W0[0])
        Jm_c, Km_c = J_c * free[:-1, None, :], K_c * free[1:, None, :]
    if hoist_H:
        Hm_c = mask_H(ocp.cost_hessian_blocks(W0[0]))

    def iteration(s: _State) -> _State:
        W, S, y, yg, z_lw, z_uw, z_ls, z_us, mu, nu = s[:10]
        mu_w = _lanes(mu, W)

        # ---- linearize (exact AD, all stages and lanes at once) ----
        if hoist_JK:
            Jm, Km = Jm_c, Km_c
            c = ocp.interval_residuals(W)
        else:
            J, K, c = ocp.interval_jacobians(W)
            Jm, Km = J * free[:-1, None, :], K * free[1:, None, :]
        grad = ocp.cost_gradient(W)
        Hm = Hm_c if hoist_H else mask_H(ocp.cost_hessian_blocks(W))
        gm = grad * free
        if ng:
            r = ocp.general_rows(W)[0]
            Gm = ocp.general_row_jacobians(W) * free[:, None, :]

        # ---- primal-dual Σ terms (bound duals eliminated) ----
        dLw, dUw = safe_dist(W, lb, ub, mwL, mwU)
        sig_w = where0(mwL, z_lw / dLw) + where0(mwU, z_uw / dUw)
        if ng:
            dLs, dUs = safe_dist(S, sl, su, msL, msU)
            sig_s = (where0(msL, z_ls / dLs) + where0(msU, z_us / dUs)
                     + where0(s_inactive, torch.ones_like(dLs)) + reg_p)

        # ---- stationarity residuals (true KKT, and the barrier rhs) ----
        AtY = interval_to_stage(mv_small_t(Jm, y), mv_small_t(Km, y))
        if ng:
            AtY = AtY + mv_small_t(Gm, yg)
        rW = (gm + AtY - where0(mwL, z_lw) + where0(mwU, z_uw)) * free
        rW_bar = (gm + AtY - where0(mwL, mu_w / dLw) + where0(mwU, mu_w / dUw)) * free
        if ng:
            rs = -yg - where0(msL, z_ls) + where0(msU, z_us)
            rs_bar = -yg - where0(msL, mu_w / dLs) + where0(msU, mu_w / dUs)
            rg = r - S

        with span("ip.newton"):
            # ---- condensed stage Hessian H_hat and its inverse ----
            H_hat = (Hm + torch.diag_embed(sig_w * free) + reg_p * eye_nz
                     + pin[:, :, None] * pin[:, None, :] * eye_nz)
            if ng:
                GmT = Gm.transpose(-1, -2)
                H_hat = H_hat + mm_small_nt(GmT * sig_s[..., None, :], GmT)
            Hinv = inv_spd_small(H_hat)
            rhs1 = -rW_bar
            if ng:
                rhs1 = rhs1 - mv_small_t(Gm, sig_s * rg + rs_bar) * free

            # ---- Schur complement over the interval rows (block-tridiagonal) ----
            JH = mm_small(Jm, Hinv[:, :-1])
            KH = mm_small(Km, Hinv[:, 1:])
            S_D = mm_small_nt(JH, Jm) + mm_small_nt(KH, Km) + reg_d * eye_nc
            S_O = mm_small_nt(KH[:, :-1], Jm[..., 1:, :, :])
            Hr = mv_small(Hinv, rhs1)
            rhs_y = mv_small(Jm, Hr[:, :-1]) + mv_small(Km, Hr[:, 1:]) + c
            with span("k4.launch"):
                dy = btridiag_factor_solve(S_D, S_O, rhs_y, inplace=inplace)

            # ---- back-substitute ΔW, Δy_gen, Δs, Δz ----
            AtDy = interval_to_stage(mv_small_t(Jm, dy), mv_small_t(Km, dy))
            dW = mv_small(Hinv, rhs1 - AtDy) * free
            if ng:
                dyg = sig_s * (mv_small(Gm, dW) + rg) + rs_bar
                dS = (dyg - rs_bar) / sig_s
            else:
                dyg = dS = torch.zeros_like(S)
            dz_lw = where0(mwL, -z_lw + mu_w / dLw - (z_lw / dLw) * dW)
            dz_uw = where0(mwU, -z_uw + mu_w / dUw + (z_uw / dUw) * dW)
            if ng:
                dz_ls = where0(msL, -z_ls + mu_w / dLs - (z_ls / dLs) * dS)
                dz_us = where0(msU, -z_us + mu_w / dUs + (z_us / dUs) * dS)

        # ---- fraction-to-boundary step limits ----
        tau = _lanes(torch.clamp(1.0 - mu, min=cfg.tau_min), W)

        def max_step(d, dist, mask):
            # the largest α with v + α·d keeping τ of the distance to the bound
            lim = torch.where(mask & (d < 0), -tau * dist / torch.clamp(d, max=-tiny), one)
            return lim.amin(dim=(-2, -1))

        a_p = torch.minimum(max_step(dW, dLw, mwL), max_step(-dW, dUw, mwU))
        a_z = torch.minimum(max_step(dz_lw, z_lw, mwL), max_step(dz_uw, z_uw, mwU))
        if ng:
            a_p = torch.minimum(a_p, torch.minimum(max_step(dS, dLs, msL),
                                                   max_step(-dS, dUs, msU)))
            a_z = torch.minimum(a_z, torch.minimum(max_step(dz_ls, z_ls, msL),
                                                   max_step(dz_us, z_us, msU)))
        a_p = torch.clamp(a_p, 0.0, 1.0)
        a_z = torch.clamp(a_z, 0.0, 1.0)

        # ---- backtracking Armijo on the barrier ℓ1 merit ----
        with span("ip.line_search"):
            y_max = _amax2((dy + y).abs())
            if ng:
                y_max = torch.maximum(y_max, _amax2((yg + dyg).abs()))
            nu_new = torch.maximum(nu, 1.2 * y_max + 1e-3)
            phi0, infeas0 = barrier_merit(W, S, mu, nu_new)
            # directional derivative of the smooth part f − μ·Σ logs along (ΔW, Δs)
            dlogs = _sum2(where0(mwL, dW / dLw)) - _sum2(where0(mwU, dW / dUw))
            if ng:
                dlogs = dlogs + _sum2(where0(msL, dS / dLs)) - _sum2(where0(msU, dS / dUs))
            dirderiv = _sum2(grad * dW) - mu * dlogs - nu_new * infeas0
            # the candidates in a leading dim: [n_cand, B, ...]
            steps = a_p * backtracks[:, None]
            st = steps[..., None, None]
            phis, _ = barrier_merit(W + st * dW, S + st * dS, mu, nu_new)
            armijo = phis <= phi0 + cfg.ls_c1 * steps * torch.clamp(dirderiv, max=0.0)
            any_ok = armijo.any(dim=0)
            idx = armijo.to(torch.int8).argmax(dim=0)  # first True = largest step
            alpha = a_p * torch.where(any_ok, backtracks[idx], backtracks[-1])
        al = _lanes(alpha, W)
        az = _lanes(a_z, W)

        W_new, S_new = W + al * dW, S + al * dS
        y_new, yg_new = y + al * dy, yg + al * dyg
        z_lw_new, z_uw_new = z_lw + az * dz_lw, z_uw + az * dz_uw
        if ng:
            z_ls_new, z_us_new = z_ls + az * dz_ls, z_us + az * dz_us
        else:
            z_ls_new, z_us_new = z_ls, z_us

        # κ_Σ dual-consistency clip
        ks = cfg.kappa_sigma

        def z_clip(z, d, mask):
            return torch.where(
                mask, torch.minimum(torch.maximum(z, mu_w / (ks * d)), ks * mu_w / d), z)

        dLw_n, dUw_n = safe_dist(W_new, lb, ub, mwL, mwU)
        z_lw_new, z_uw_new = z_clip(z_lw_new, dLw_n, mwL), z_clip(z_uw_new, dUw_n, mwU)
        if ng:
            dLs_n, dUs_n = safe_dist(S_new, sl, su, msL, msU)
            z_ls_new, z_us_new = z_clip(z_ls_new, dLs_n, msL), z_clip(z_us_new, dUs_n, msU)

        # ---- KKT error (at the linearization point) ----
        stat = _amax2(rW.abs())
        feas = _amax2(c.abs())
        if ng:
            feas = torch.maximum(feas, _amax2(rg.abs()))
            stat = torch.maximum(stat, _amax2(rs.abs()))
        cw = (where0(mwL, dLw * z_lw), where0(mwU, dUw * z_uw))
        comp0 = [_amax2(cw[0].abs()), _amax2(cw[1].abs())]
        comp_mu = [_amax2((cw[0] - where0(mwL, mu_w.expand_as(cw[0]))).abs()),
                   _amax2((cw[1] - where0(mwU, mu_w.expand_as(cw[1]))).abs())]
        if ng:
            mu_s = _lanes(mu, S).expand_as(S)
            cs = (where0(msL, dLs * z_ls), where0(msU, dUs * z_us))
            comp0 += [_amax2(cs[0].abs()), _amax2(cs[1].abs())]
            comp_mu += [_amax2((cs[0] - where0(msL, mu_s)).abs()),
                        _amax2((cs[1] - where0(msU, mu_s)).abs())]
        comp = torch.stack(comp0).amax(dim=0)
        comp_m = torch.stack(comp_mu).amax(dim=0)
        E0 = torch.maximum(torch.maximum(stat, feas), comp)
        Emu = torch.maximum(torch.maximum(stat, feas), comp_m)

        converged = E0 < tol
        # μ update once the barrier subproblem is solved (IPOPT eq. 7)
        inner_done = Emu <= cfg.kappa_eps * mu
        mu_next = torch.clamp(
            torch.minimum(cfg.kappa_mu * mu, mu ** cfg.theta_mu), min=tol / 10.0)
        mu_new = torch.where(inner_done & ~converged, mu_next, mu)

        # numerical breakdown (an infeasible problem's duals diverge): keep
        # the last finite iterate and flag the lane
        bad = ~(torch.isfinite(W_new).all(dim=(-2, -1))
                & torch.isfinite(y_new).all(dim=(-2, -1)) & torch.isfinite(E0))
        hold = s.done | bad

        def keep(old, new):
            return torch.where(_lanes(hold, new), old, new)

        return _State(
            keep(W, W_new), keep(S, S_new), keep(y, y_new), keep(yg, yg_new),
            keep(z_lw, z_lw_new), keep(z_uw, z_uw_new),
            keep(z_ls, z_ls_new), keep(z_us, z_us_new),
            keep(mu, mu_new), keep(nu, nu_new),
            torch.where(s.done, s.it, s.it + 1),
            keep(s.stat, stat), keep(s.feas, feas), keep(s.comp, comp),
            s.done | (converged & ~bad), s.diverged | (bad & ~s.done),
        )

    inf = torch.full((B,), math.inf, **kw)
    false = torch.zeros((B,), dtype=torch.bool, device=dev)
    state = _State(
        W0, S0, torch.zeros((B, N, nc), **kw), torch.zeros((B, N + 1, ng), **kw),
        z_lw0, z_uw0, z_ls0, z_us0, mu0, torch.full((B,), cfg.merit_nu_init, **kw),
        torch.zeros((B,), dtype=torch.int32, device=dev), inf, inf, inf, false, false,
    )
    trips = 0
    while True:
        active = (state.it < cfg.max_iter) & ~state.done & ~state.diverged
        more = active.any()
        # the one wait of the host on the device in a lock-step iteration
        with span("ip.wait"):
            more = bool(more)
        if not more:
            break
        trips += 1
        count("ip.lockstep_iters")
        new = iteration(state)
        state = _State(*(torch.where(_lanes(active, n), n, o) for n, o in zip(new, state)))

    status = torch.where(
        state.diverged, int(SolverStatus.INFEASIBLE),
        torch.where(state.done, int(SolverStatus.CONVERGED), int(SolverStatus.EARLY_TERMINATED)),
    ).to(torch.int32)
    # useful lane iterations against the slots lock step gave the lanes
    count("ip.lane_iters", state.it)
    count("ip.lane_slots", B * trips)
    un = lambda a: a.reshape(lead + tuple(a.shape[1:]))
    W = un(state.W)
    return IPResult(
        traj=ocp.unpack(W), W=W, S=un(state.S), y_dyn=un(state.y), y_gen=un(state.yg),
        z_lw=un(state.z_lw), z_uw=un(state.z_uw), iterations=un(state.it),
        objective=un(ocp.objective_from_W(state.W)), stat_res=un(state.stat),
        feas_res=un(state.feas), comp_res=un(state.comp), mu=un(state.mu),
        status=un(status),
    )
