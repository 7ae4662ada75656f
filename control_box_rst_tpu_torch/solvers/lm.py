"""Levenberg-Marquardt solver (LSQ penalty mode), batched.

Counterpart of the JAX package's ``solvers/lm.py``:

  residual r(z) = [ lsq-objective residuals ;
                    √w_eq · c_eq ; √w_ineq · general-row violation ;
                    √w_b · bound violation ]
  H = JᵀJ + μI,  Δ = -H⁻¹ Jᵀ r,  trust-region-style μ update (ρ-gain test,
  ν-doubling on rejection), penalty weights grown by ``weight_adapt_factor``
  up to a max when the iteration stalls at an infeasible point.

Residuals are stage-blocked (r_k couples w_k, w_{k+1}), so JᵀJ is
block-tridiagonal: the linear solve of every iteration is one call of
``ops/cuda/btridiag_kernel.btridiag_factor_solve`` (factor, forward and
backward sweep in one kernel launch on the card; its plain version on the
CPU). Jacobians are exact ``torch.func.jacfwd`` blocks of the interval
residual, hinges included.

Batch-first where the reference is vmapped: ``lm_solve`` takes a batched
``ocp.bc.x0`` / ``traj0`` directly, keeps every scalar of the reference's
loop state (μ, ν, the three penalty weights, the iteration counter, ``done``,
the χ² memory) as a [B] tensor, masks every update by the lane's own loop
condition — a lane whose condition is false is frozen whole, counter
included, as a vmapped ``while_loop`` freezes it — and stops when no lane's
condition holds.

General rows (ng > 0) enter as two-sided hinges max(0, r − ru) +
max(0, rl − r) of the stage rows in each interval block and of the terminal
rows in the terminal block, weighted by √w_ineq (grown on a stall with the
other weights); the linear system keeps its nz × nz blocks.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from control_box_rst_tpu_torch.core.types import SolverStatus
from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.ocp.transcribe import TranscribedOCP
from control_box_rst_tpu_torch.ops.btridiag import btridiag_matvec, interval_to_stage
from control_box_rst_tpu_torch.ops.cuda.btridiag_kernel import btridiag_factor_solve
from control_box_rst_tpu_torch.ops.smallmat import mm_small_tn, mv_small_t
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class LMConfig:
    max_iter: int = 50
    mu_init: float = 1e-4
    tol_chi2_rel: float = 1e-10
    tol_step: float = 1e-10
    # penalty weights
    weight_eq: float = 2.0
    weight_ineq: float = 2.0
    weight_bounds: float = 2.0
    weight_adapt_factor: float = 10.0
    weight_max: float = 1e8
    # unweighted dynamics-defect tolerance for convergence
    feas_tol: float = 1e-6


class LMResult(NamedTuple):
    traj: Trajectory
    W: torch.Tensor
    chi2: torch.Tensor
    iterations: torch.Tensor
    feas_res: torch.Tensor
    status: torch.Tensor


class LMState(NamedTuple):
    """Loop state of ``lm_solve``: W [B, N+1, nz], everything else [B]."""

    W: torch.Tensor
    mu: torch.Tensor
    nu_reject: torch.Tensor
    w_eq: torch.Tensor
    w_ineq: torch.Tensor
    w_b: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    chi2_prev: torch.Tensor


def _pad_last(r: torch.Tensor, n: int) -> torch.Tensor:
    pad = n - r.shape[-1]
    if not pad:
        return r
    return torch.cat([r, r.new_zeros(r.shape[:-1] + (pad,))], dim=-1)


def _hinge(v: torch.Tensor) -> torch.Tensor:
    """max(0, v), with the tie rule of the reference's ``maximum`` under
    forward-mode differentiation."""
    return torch.maximum(torch.zeros_like(v), v)


def _with_value(fn):
    """fn → (value, value): under ``jacfwd(..., has_aux=True)`` the residual
    comes back beside its Jacobian from the one evaluation."""
    def wrapped(*args):
        r = fn(*args)
        return r, r
    return wrapped


class LMProblem:
    """The stage-blocked least-squares problem of one OCP: residuals, χ², the
    block-tridiagonal Gauss-Newton system, and one LM iteration on a batch of
    lanes. ``lm_solve`` builds one per call; the tests build it to compare
    its parts with the reference."""

    def __init__(self, ocp: TranscribedOCP, cfg: LMConfig, dtype, inplace: bool = True):
        self.ocp, self.cfg, self.inplace = ocp, cfg, inplace
        self.free = 1.0 - ocp.fixed_mask().to(dtype)
        lb, ub = ocp.w_bounds()
        # finite-infinity clamp: keep all arithmetic finite
        self.lb = torch.clamp(lb.to(dtype), min=-1e8)
        self.ub = torch.clamp(ub.to(dtype), max=1e8)
        # lsq residual lengths, probed once: the lsq slot holds the stage
        # residual on interval rows and the terminal-cost residual on the
        # terminal row, padded to a common width
        x = self.free.new_zeros((ocp.nx,))
        u = self.free.new_zeros((ocp.nu,))
        n_stage = ocp.cost.stage_residual(x, u, x.new_zeros(()), x, u).shape[-1]
        n_final = ocp.cost.final_residual(x, x).shape[-1]
        self.n_lsq = max(n_stage, n_final)
        self.ng = ocp.ng
        self.nr = self.n_lsq + ocp.nc + self.ng + ocp.nz  # rows per interval block
        if self.ng:
            # general-row bounds: the same at every stage k < N, and at N
            rl, ru = ocp.general_row_bounds()
            self.rl, self.ru = rl.to(dtype), ru.to(dtype)

    def _gen_viol(self, v, k):
        """Two-sided violation of the general rows v [..., ng] of stage k
        (``0``: any stage k < N, ``-1``: stage N)."""
        return _hinge(v - self.ru[k]) + _hinge(self.rl[k] - v)

    # ---------------- residuals ----------------
    def interval_res(self, w, w1, xref, uref, m, tie, utie, lb, ub, free, w_eq, w_b, w_ineq):
        """Stage-blocked residual r_k(w_k, w_{k+1}) ∈ R^nr. ``w``, ``w1``
        [..., nz]; the stage data (``xref`` … ``free``) and the penalty
        weights [...] broadcast over leading dims."""
        ocp = self.ocp
        x, u, dt = ocp.split_w(w, ocp.nx, ocp.nu)
        # lsq objective residual (√-weighted quadrature: left-sum style)
        r_lsq = _pad_last(ocp.cost.stage_residual(x, u, dt, xref, uref), self.n_lsq)
        scale = m
        if ocp.cost.integral:
            scale = m * torch.sqrt(torch.clamp(dt, min=1e-12))
        # equality: interval rows (defect + ties)
        c = ocp.interval_residual(w, w1, m, tie, utie)
        parts = [scale[..., None] * r_lsq, torch.sqrt(w_eq)[..., None] * c]
        # general rows at stage k (the two-sided hinge covers eq and ineq rows)
        if self.ng:
            v = ocp.stage_rows(w, m, xref, uref)
            parts.append(torch.sqrt(w_ineq)[..., None] * self._gen_viol(v, 0))
        # box violation at stage k
        viol = _hinge(lb - w) + _hinge(w - ub)
        parts.append(torch.sqrt(w_b)[..., None] * viol * free)
        return torch.cat(parts, dim=-1)

    def terminal_res(self, wN, w_b, w_ineq):
        """Terminal block: the terminal-cost LSQ residual in the lsq slot,
        no equality rows, the terminal rows' violation, the box violation of
        stage N."""
        ocp, N = self.ocp, self.ocp.N
        rf = _pad_last(
            ocp.cost.final_residual(wN[..., : ocp.nx], ocp.refs.xref[-1]), self.n_lsq)
        parts = [rf, rf.new_zeros(rf.shape[:-1] + (ocp.nc,))]
        if self.ng:
            v = ocp.terminal_rows(wN)
            parts.append(torch.sqrt(w_ineq)[..., None] * self._gen_viol(v, -1))
        viol = _hinge(self.lb[N] - wN) + _hinge(wN - self.ub[N])
        parts.append(torch.sqrt(w_b)[..., None] * viol * self.free[N])
        return torch.cat(parts, dim=-1)

    def _stage_data(self):
        refs = self.ocp.refs
        return (refs.xref[:-1], refs.uref, self.ocp.stage_mask, self.ocp.tie_mask,
                self.ocp.u_tie_mask, self.lb[:-1], self.ub[:-1], self.free[:-1])

    def all_residuals(self, W, w_eq, w_b, w_ineq):
        """r_int [B, N, nr], r_term [B, nr] for W [B, N+1, nz], weights [B]."""
        r_int = self.interval_res(
            W[:, :-1], W[:, 1:], *self._stage_data(), w_eq[:, None], w_b[:, None],
            w_ineq[:, None])
        return r_int, self.terminal_res(W[:, -1], w_b, w_ineq)

    def chi2_of(self, W, w_eq, w_b, w_ineq):
        r_int, r_term = self.all_residuals(W, w_eq, w_b, w_ineq)
        return (r_int ** 2).sum(dim=(-2, -1)) + (r_term ** 2).sum(dim=-1)

    # ---------------- Gauss-Newton system ----------------
    def gn_system(self, W, w_eq, w_b, w_ineq):
        """Block-tridiagonal JᵀJ (D [B, N+1, nz, nz], O [B, N, nz, nz]) and
        Jᵀr (g [B, N+1, nz]), with χ² = rᵀr [B] of the same residuals."""
        free, N = self.free, self.ocp.N
        jac = torch.func.jacfwd(_with_value(self.interval_res), argnums=(0, 1), has_aux=True)
        over_stages = torch.func.vmap(jac, in_dims=(0,) * 10 + (None,) * 3)
        # the stage data is shared by the lanes, but for a per-lane mask
        mask_dim = 0 if self.ocp.per_lane_mask else None
        over_lanes = torch.func.vmap(
            over_stages, in_dims=(0, 0, None, None, mask_dim) + (None,) * 5 + (0, 0, 0))
        (J, K), r_int = over_lanes(
            W[:, :-1], W[:, 1:], *self._stage_data(), w_eq, w_b, w_ineq)
        J = J * free[:-1, None, :]
        K = K * free[1:, None, :]
        jac_term = torch.func.jacfwd(_with_value(self.terminal_res), has_aux=True)
        J_term, r_term = torch.func.vmap(jac_term)(W[:, -1], w_b, w_ineq)
        J_term = J_term * free[N][None, :]

        # block products as broadcast-multiply-sum (ops/smallmat.py): one
        # launch each, where a batched library product of B·N tiny blocks is
        # cut into dozens of launches
        zero = W.new_zeros((W.shape[0], 1) + (W.shape[-1],) * 2)
        D = (torch.cat([mm_small_tn(J, J), zero], dim=1)
             + torch.cat([zero, mm_small_tn(K, K)], dim=1))
        D[:, N] += mm_small_tn(J_term, J_term)
        O = mm_small_tn(J, K)
        g = interval_to_stage(mv_small_t(J, r_int), mv_small_t(K, r_int))
        g[:, N] += mv_small_t(J_term, r_term)
        chi2 = (r_int ** 2).sum(dim=(-2, -1)) + (r_term ** 2).sum(dim=-1)
        return D, O, g, chi2

    # ---------------- feasibility ----------------
    def feasibility(self, W):
        """Unweighted max of dynamics defects, box violations and general-row
        violations, [B]."""
        feas = self.ocp.interval_residuals(W).abs().amax(dim=(-2, -1))
        viol_box = (_hinge(self.lb - W) + _hinge(W - self.ub)) * self.free
        feas = torch.maximum(feas, viol_box.amax(dim=(-2, -1)))
        if self.ng:
            r, _, _ = self.ocp.general_rows(W)
            viol = _hinge(r - self.ru) + _hinge(self.rl - r)
            feas = torch.maximum(feas, viol.amax(dim=(-2, -1)))
        return feas

    # ---------------- one iteration ----------------
    def init_state(self, W0) -> LMState:
        cfg, B = self.cfg, W0.shape[0]
        full = lambda v: torch.full((B,), v, dtype=W0.dtype, device=W0.device)
        return LMState(
            W=W0, mu=full(cfg.mu_init), nu_reject=full(2.0),
            w_eq=full(cfg.weight_eq), w_ineq=full(cfg.weight_ineq),
            w_b=full(cfg.weight_bounds),
            it=torch.zeros((B,), dtype=torch.int32, device=W0.device),
            done=torch.zeros((B,), dtype=torch.bool, device=W0.device),
            chi2_prev=full(math.inf),
        )

    def cond(self, s: LMState) -> torch.Tensor:
        return (s.it < self.cfg.max_iter) & ~s.done

    def damped_system(self, s: LMState):
        """The linear system of an iteration, (JᵀJ + μI) Δ = −Jᵀr, as
        (Dmu, D, O, g, χ²): the Gauss-Newton blocks with the lane's μ on the
        diagonal of D."""
        D, O, g, chi2 = self.gn_system(s.W, s.w_eq, s.w_b, s.w_ineq)
        eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
        return D + s.mu[:, None, None, None] * eye, D, O, g, chi2

    def iteration(self, s: LMState) -> LMState:
        """One LM iteration on every lane (the caller masks by ``cond``)."""
        cfg = self.cfg
        W, mu = s.W, s.mu
        Dmu, D, O, g, chi2_old = self.damped_system(s)
        delta = -btridiag_factor_solve(Dmu, O, g, inplace=self.inplace) * self.free
        W_new = W + delta
        chi2_new = self.chi2_of(W_new, s.w_eq, s.w_b, s.w_ineq)
        # ρ-gain: predicted reduction from the GN model
        pred = -(g * delta).sum(dim=(-2, -1)) - 0.5 * (
            delta * btridiag_matvec(D, O, delta)).sum(dim=(-2, -1))
        actual = chi2_old - chi2_new
        rho_gain = actual / torch.clamp(pred.abs(), min=1e-30)
        accept = actual > 0
        W_next = torch.where(accept[:, None, None], W_new, W)
        # μ update
        mu_acc = mu * torch.clamp(1.0 - (2.0 * rho_gain - 1.0) ** 3, min=1.0 / 3.0)
        mu_new = torch.where(accept, mu_acc, mu * s.nu_reject)
        nu_new = torch.where(accept, torch.full_like(mu, 2.0), s.nu_reject * 2.0)
        chi2_cur = torch.where(accept, chi2_new, chi2_old)
        step_norm = delta.abs().amax(dim=(-2, -1))
        stalled = (step_norm < cfg.tol_step) | (
            (s.chi2_prev - chi2_cur).abs() < cfg.tol_chi2_rel * (1.0 + chi2_cur))
        # feasibility at the current iterate (unweighted): dynamics defects
        # and box violations — declaring convergence on defects alone lets
        # the penalty weights stall while bound rows are still violated
        feasible = self.feasibility(W_next) < cfg.feas_tol
        # when stalled but infeasible: grow penalty weights and keep going;
        # stalled + feasible: done
        adapt = stalled & ~feasible
        grow = lambda w: torch.where(
            adapt, torch.clamp(w * cfg.weight_adapt_factor, max=cfg.weight_max), w)
        # reset chi2 memory when weights change (chi2 scale jumps)
        chi2_mem = torch.where(adapt, torch.full_like(chi2_cur, math.inf), chi2_cur)
        return LMState(
            W=W_next, mu=mu_new, nu_reject=nu_new,
            w_eq=grow(s.w_eq), w_ineq=grow(s.w_ineq), w_b=grow(s.w_b),
            it=s.it + 1, done=s.done | (stalled & feasible), chi2_prev=chi2_mem,
        )


def freeze_inactive(active: torch.Tensor, new: LMState, old: LMState) -> LMState:
    """Lanes whose loop condition is false keep their whole state."""
    pick = lambda n, o: torch.where(active.view((-1,) + (1,) * (n.dim() - 1)), n, o)
    return LMState(*(pick(n, o) for n, o in zip(new, old)))


def lm_solve(
    ocp: TranscribedOCP,
    traj0: Trajectory,
    cfg: Optional[LMConfig] = None,
    inplace: bool = True,
) -> LMResult:
    """Levenberg-Marquardt on the stage NLP, for one problem or a batch
    (``ocp.bc.x0`` [..., nx] and/or ``traj0`` with leading dims). Every field
    of the result carries those leading dims. ``inplace`` is handed to
    ``btridiag_factor_solve`` (which of its two kernels solves the linear
    system on the card); the answer does not depend on it."""
    cfg = cfg or LMConfig()
    traj0 = ocp.apply_boundary(traj0)
    # a per-lane stage mask gives the iterate its lanes; both are flattened
    # to one lane dim
    W0 = ocp.with_mask_lanes(ocp.pack(traj0))
    lead = W0.shape[:-2]
    if ocp.per_lane_mask:
        ocp = ocp.replace(stage_mask=ocp.stage_mask.expand(lead + (ocp.N,)).reshape(-1, ocp.N))
    prob = LMProblem(ocp, cfg, W0.dtype, inplace)
    state = prob.init_state(W0.reshape((-1,) + W0.shape[-2:]))
    while True:
        active = prob.cond(state)
        if not bool(active.any()):
            break
        state = freeze_inactive(active, prob.iteration(state), state)
    W = state.W
    feas = ocp.interval_residuals(W).abs().amax(dim=(-2, -1))
    status = torch.where(
        state.done & (feas < 1e-4),
        int(SolverStatus.CONVERGED), int(SolverStatus.EARLY_TERMINATED),
    ).to(torch.int32)
    W = W.reshape(lead + W.shape[-2:])
    return LMResult(
        traj=ocp.unpack(W), W=W, chi2=state.chi2_prev.reshape(lead),
        iterations=state.it.reshape(lead), feas_res=feas.reshape(lead),
        status=status.reshape(lead),
    )
