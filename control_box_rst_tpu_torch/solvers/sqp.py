"""SQP solver for stage NLPs, batch-first.

Counterpart of the JAX package's ``solvers/sqp.py``. Structure:

  linearize (exact AD, all stages and lanes at once)
    → stage QP (block-tridiagonal ADMM, warm-started)
    → ℓ1-merit backtracking line search (all candidate steps evaluated
      in parallel)
    → KKT residual check, per-lane convergence mask

Every lane of a batch ([B, N+1, nz]) is an independent MPC solve with its
own convergence state. The reference's vmapped ``while_loop`` becomes a
Python loop with a per-lane ``done`` mask: a finished lane is frozen — extra
iterations do not move it — and the loop ends when every lane is done or the
iteration budget is spent.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from control_box_rst_tpu_torch.core.types import SolverStatus
from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.ocp.transcribe import TranscribedOCP
from control_box_rst_tpu_torch.ops.btridiag import interval_to_stage
from control_box_rst_tpu_torch.solvers.stage_qp import (
    QPConfig,
    QPWarmStart,
    StageQP,
    solve_stage_qp,
)
from control_box_rst_tpu_torch.utils.precision import check_precision_policy
from control_box_rst_tpu_torch.utils.profiling import count, recording, span
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class SQPConfig:
    max_iter: int = 30
    qp: QPConfig = None
    # None → dtype-calibrated at solve time: f64 → (1e-6, 1e-7);
    # f32 (the production path) → (5e-4, 2e-5)
    tol_stat: Optional[float] = None
    tol_feas: Optional[float] = None
    ls_candidates: int = 8
    ls_c1: float = 1e-4
    merit_nu_init: float = 10.0
    psd_clamp: bool = False
    # proximal damping λ‖δ‖² added to the QP Hessian diagonal
    prox: float = 0.0
    # watchdog arming threshold: the full-step rescue only fires when the
    # CURRENT iterate's ℓ1 infeasibility is already below this
    rescue_infeas_max: float = 1e-3

    def __post_init__(self):
        if self.qp is None:
            object.__setattr__(self, "qp", QPConfig())


class SQPResult(NamedTuple):
    traj: Trajectory
    W: torch.Tensor
    y_dyn: torch.Tensor
    y_gen: torch.Tensor
    y_box: torch.Tensor
    iterations: torch.Tensor
    objective: torch.Tensor
    stat_res: torch.Tensor
    feas_res: torch.Tensor
    status: torch.Tensor  # SolverStatus int32
    qp_iters: torch.Tensor


class SQPWarmStart(NamedTuple):
    W: torch.Tensor
    y_dyn: torch.Tensor
    y_gen: torch.Tensor
    y_box: torch.Tensor


class SQPHoisted(NamedTuple):
    """Pin-masked constant structure of an LTI problem (``hoist_structure``):
    ``Jm``, ``Km`` [..., N, nc, nz] when the interval Jacobians are constant
    in W, ``Hm`` [..., N+1, nz, nz] when the cost Hessian is too; else None."""
    Jm: Optional[torch.Tensor]
    Km: Optional[torch.Tensor]
    Hm: Optional[torch.Tensor]


def resolve_qp_backend(cfg: SQPConfig, ng: int, device, dtype) -> SQPConfig:
    """``cfg`` with ``qp.backend=None`` resolved for a solve on ``device`` in
    ``dtype``: 'fused' (the box-QP kernel) for float32 without general rows
    on the card, else 'plain'. A backend named by the caller stays."""
    if cfg.qp.backend is not None:
        return cfg
    fused = torch.device(device).type == "cuda" and dtype == torch.float32 and ng == 0
    return cfg.replace(qp=cfg.qp.replace(backend="fused" if fused else "plain"))


def _amax2(a: torch.Tensor) -> torch.Tensor:
    """Per-lane max over the trailing [stage, entry] dims."""
    return a.amax(dim=(-2, -1))


def _merit(ocp: TranscribedOCP, W, lb, ub, nu, free):
    """ℓ1 merit φ = f + ν·infeas per lane. Box violations are counted on FREE
    entries only: pinned entries (x0 row, fixed-xf components, stage-N dummy
    u/dt, fixed-dt columns) are equalities maintained by construction, and
    the dummy slots sit OUTSIDE the broadcast bounds (the stage-N dt dummy is
    0 vs dt bounds [0.1, 0.1]) — counting them would add a constant,
    irreducible infeasibility that no step can reduce."""
    f = ocp.objective_from_W(W)
    c = ocp.interval_residuals(W)
    r, rl, ru = ocp.general_rows(W)
    viol_gen = torch.clamp(rl - r, min=0.0) + torch.clamp(r - ru, min=0.0)
    viol_box = (torch.clamp(lb - W, min=0.0) + torch.clamp(W - ub, min=0.0)) * free
    infeas = (
        c.abs().sum(dim=(-2, -1)) + viol_gen.sum(dim=(-2, -1))
        + viol_box.sum(dim=(-2, -1))
    )
    return f + nu * infeas, infeas


def _grad_lagrangian(gm, Jm, Km, y_dyn, y_box, free):
    gl = gm + interval_to_stage(
        torch.einsum("...kri,...kr->...ki", Jm, y_dyn),
        torch.einsum("...kri,...kr->...ki", Km, y_dyn),
    )
    return gl + y_box * free


def _psd_clamp(H: torch.Tensor, floor: float = 1e-8) -> torch.Tensor:
    """H with its eigenvalues clamped to ``floor`` (symmetric blocks)."""
    w, V = torch.linalg.eigh(H)
    return torch.einsum("...ij,...j,...kj->...ik", V, torch.clamp(w, min=floor), V)


def _clamps(ocp: TranscribedOCP, psd_clamp: bool) -> bool:
    """Whether the Hessian blocks are clamped to PSD: when asked, or when
    the cost is not convex."""
    return bool(psd_clamp) or not getattr(ocp.cost, "convex", True)


def _mask_hessian(Hd, free, prox: float, clamp: bool = False):
    if clamp:
        Hd = _psd_clamp(Hd)
    if prox:
        Hd = Hd + prox * torch.eye(Hd.shape[-1], dtype=Hd.dtype, device=Hd.device)
    return Hd * free[:, None, :] * free[:, :, None]


def hoist_structure(
    ocp: TranscribedOCP, traj0: Trajectory, cfg: Optional[SQPConfig] = None
) -> SQPHoisted:
    """Evaluate what is constant over the SQP iterations, once.

    LTI ⇒ J, K are the same at every W; they are evaluated at a state-zeroed
    reference trajectory (keeping u/dt from traj0 — J/K depend on dt). In the
    batched solver x0 enters only through traj0.X while U and dts are shared
    by all lanes and carry no batch dim, so the reference point is UNBATCHED
    and the whole linearization (and the constant Hessian) is evaluated once
    per batch, not once per lane; with batched U/dts it degrades gracefully
    to the per-lane evaluation. The result depends on the OCP, on traj0's U
    and dts and on ``cfg.prox`` only, so a caller that solves many batches
    from the same initial guess (``make_batched_solver``) computes it once
    and passes it to ``sqp_solve`` — what tracing under ``jit`` does for the
    reference.

    Nothing is hoisted for a per-lane stage mask: the identity-chain rows of
    J/K and the masked cost blocks differ from lane to lane, so one shared
    copy would give every lane the first lane's horizon."""
    cfg = cfg or SQPConfig()
    if not ocp.lti_structure or ocp.per_lane_mask:
        return SQPHoisted(None, None, None)
    N, nz = ocp.N, ocp.nz
    dtype, dev = traj0.X.dtype, traj0.X.device
    free = 1.0 - ocp.fixed_mask().to(dtype)
    lead_ref = torch.broadcast_shapes(traj0.U.shape[:-2], traj0.dts.shape[:-1])
    traj_ref = traj0.replace(
        X=torch.zeros(lead_ref + (N + 1, ocp.nx), dtype=dtype, device=dev)
    )
    W_jac = ocp.pack(traj_ref)
    J_c, K_c, _ = ocp.interval_jacobians(W_jac)
    Hm = None
    if ocp.constant_hessian:
        Hm = _mask_hessian(ocp.cost_hessian_blocks(W_jac), free, cfg.prox,
                           _clamps(ocp, cfg.psd_clamp))
    return SQPHoisted(
        Jm=J_c * free[:-1, None, :], Km=K_c * free[1:, None, :], Hm=Hm
    )


class SQPContext(NamedTuple):
    """What stays fixed over the loop trips of one ``sqp_solve``: the OCP,
    the settings, the tolerances, the pin mask, the bounds, the line-search
    step lengths and the hoisted structure (``_sqp_start``)."""
    ocp: TranscribedOCP
    cfg: SQPConfig
    lead: tuple
    tol_stat: float
    tol_feas: float
    free: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    alphas: torch.Tensor
    hoisted: SQPHoisted
    hoist_JK: bool
    hoist_H: bool
    clamp: bool
    one_shot: bool
    empty_G: torch.Tensor
    empty_g: torch.Tensor


class SQPIterate(NamedTuple):
    """The state the SQP loop carries from trip to trip, per lane."""
    W: torch.Tensor
    y_dyn: torch.Tensor
    y_gen: torch.Tensor
    y_box: torch.Tensor
    nu: torch.Tensor
    it: torch.Tensor
    stat: torch.Tensor
    feas: torch.Tensor
    done: torch.Tensor
    qp_tot: torch.Tensor


# clamp ±inf to a large finite value (OSQP's OSQP_INFTY trick): keeps every
# arithmetic path finite, inf−inf / 0·inf NaNs are ruled out
BIG = 1e8


@span("sqp.solve")
def sqp_solve(
    ocp: TranscribedOCP,
    traj0: Trajectory,
    cfg: Optional[SQPConfig] = None,
    warm: Optional[SQPWarmStart] = None,
    hoisted: Optional[SQPHoisted] = None,
) -> SQPResult:
    """Solve the transcribed OCP starting from traj0, for every lane of the
    leading dims of ``ocp.bc.x0`` / ``traj0``. Runs on the device and in the
    dtype of its inputs. ``hoisted`` takes a precomputed ``hoist_structure``
    result for this OCP and this traj0's U and dts.

    General rows (ng > 0) go into every QP as G δ ∈ [rl − r, ru − r] with
    their duals ``y_gen`` warm-started, in the merit and in the KKT test;
    they are evaluated at every iteration (nothing of G is hoisted), and the
    QP takes the non-fused ADMM. The Hessian blocks are clamped to PSD when
    ``cfg.psd_clamp`` is set or the cost is not convex.

    The same solve in three steps, for a caller that holds the first in a
    CUDA graph (``sim/step_graphs.py``): ``sqp_begin``, ``sqp_rest`` and
    ``sqp_finish``."""
    ctx, s = _sqp_start(ocp, traj0, cfg, warm, hoisted)
    trips = 0
    while _sqp_wait(_sqp_more(ctx, s)):
        trips += 1
        s = _sqp_trip(ctx, s)
    _count_work(ctx, s.it, trips)
    return sqp_finish(ctx, s)


def sqp_begin(
    ocp: TranscribedOCP,
    traj0: Trajectory,
    cfg: Optional[SQPConfig] = None,
    warm: Optional[SQPWarmStart] = None,
    hoisted: Optional[SQPHoisted] = None,
):
    """``sqp_solve``'s set-up, its one-shot and one loop trip, taken
    whatever the loop's test says (exact: a trip over lanes that are all
    done or out of budget changes nothing), with no wait of the host on the
    device. Returns (the solve's ``SQPContext``, the ``SQPIterate``, the
    loop's test as a device tensor) for ``sqp_rest``."""
    ctx, s = _sqp_start(ocp, traj0, cfg, warm, hoisted)
    s = _sqp_trip(ctx, s)
    return ctx, s, _sqp_more(ctx, s)


def sqp_rest(ctx: "SQPContext", s: "SQPIterate", more: torch.Tensor):
    """The rest of the loop after ``sqp_begin``: the test on the host, the
    trips it asks for, and the solve's counters (``s.it`` is counted from a
    copy: a graph's replay overwrites it). Returns (the last iterate, the
    trips run here); ``sqp_finish`` of it is ``sqp_solve``'s result."""
    trips = 0
    while _sqp_wait(more):
        trips += 1
        s = _sqp_trip(ctx, s)
        more = _sqp_more(ctx, s)
    if recording():
        _count_work(ctx, s.it.clone(), trips + 1)
    return s, trips


def one_shot_applies(ocp: TranscribedOCP, cfg: SQPConfig) -> bool:
    """Whether ``sqp_solve`` starts with the one-shot: J, K and Hd constant
    and shared by every lane (LTI dynamics, a constant Hessian, no per-lane
    stage mask), box rows only, and the fused QP (``cfg.qp.backend``
    resolved)."""
    return (ocp.lti_structure and ocp.constant_hessian and not ocp.per_lane_mask
            and ocp.ng == 0 and cfg.qp.backend == "fused")


def _sqp_wait(more: torch.Tensor) -> bool:
    """The loop's test on the host: the one wait of the host on the device
    in a lock-step iteration."""
    with span("sqp.wait"):
        return bool(more)


def _sqp_start(ocp, traj0, cfg, warm, hoisted):
    """The set-up of ``sqp_solve`` and, where the structure allows it, the
    one-shot solve. Returns (``SQPContext``, the first ``SQPIterate``)."""
    check_precision_policy()
    if cfg is None:
        cfg = SQPConfig()
    N, nz, nc, ng = ocp.N, ocp.nz, ocp.nc, ocp.ng
    clamp = _clamps(ocp, cfg.psd_clamp)

    traj0 = ocp.apply_boundary(traj0)
    # a per-lane stage mask gives the iterate its lanes
    W0 = ocp.with_mask_lanes(ocp.pack(traj0))
    dtype, dev = W0.dtype, W0.device
    lead = tuple(W0.shape[:-2])

    tol_stat = cfg.tol_stat if cfg.tol_stat is not None else (
        1e-6 if dtype == torch.float64 else 5e-4)
    tol_feas = cfg.tol_feas if cfg.tol_feas is not None else (
        1e-7 if dtype == torch.float64 else 2e-5)

    pin = ocp.fixed_mask().to(dtype)
    free = 1.0 - pin
    lb, ub = ocp.w_bounds()
    lb = torch.clamp(lb.to(dtype), min=-BIG)
    ub = torch.clamp(ub.to(dtype), max=BIG)

    kw = dict(dtype=dtype, device=dev)
    if warm is None:
        y_dyn0 = torch.zeros(lead + (N, nc), **kw)
        y_gen0 = torch.zeros(lead + (N + 1, ng), **kw)
        y_box0 = torch.zeros(lead + (N + 1, nz), **kw)
    else:
        W0 = warm.W
        y_dyn0, y_gen0, y_box0 = warm.y_dyn, warm.y_gen, warm.y_box

    alphas = 0.5 ** torch.arange(cfg.ls_candidates, **kw)

    # ---- hoist constant structure out of the iteration loop ----
    # LTI + fixed dt: J, K are constant in W; quadratic cost: Hd constant;
    # neither under a per-lane stage mask (see ``hoist_structure``)
    if hoisted is None:
        hoisted = hoist_structure(ocp, traj0, cfg)
    Jm_c, Km_c, Hm_c = hoisted
    if ocp.per_lane_mask and Jm_c is not None:
        raise ValueError(
            "a hoisted J/K is shared by every lane and cannot serve a per-lane "
            "stage mask; pass hoisted=None")
    hoist_JK = ocp.lti_structure and not ocp.per_lane_mask
    hoist_H = ocp.constant_hessian and not ocp.per_lane_mask

    # ---- one-shot LTI fast path (single fused kernel launch) ----
    # LTI dynamics + constant quadratic Hessian + box-only constraints make
    # the NLP itself a convex QP: the first linearization is exact and the QP
    # minimizer IS the NLP minimizer. The fused kernel runs the ENTIRE solve
    # — every ρ-adaptation round, with per-lane early exit — in one launch.
    #
    # Budget: the one-shot gets the TOTAL ADMM work the outer SQP loop would
    # spend (max_iter SQP iterations × the per-QP budget); early exit makes
    # the larger cap cheap for easy lanes.
    #
    # Correctness contract: the one-shot result is checked against the EXACT
    # NLP KKT residuals, and lanes that miss tolerance fall through into the
    # standard outer SQP loop (their `done` flag starts False) — the
    # one-shot can only accelerate, never degrade.
    one_shot = one_shot_applies(ocp, cfg)
    it0 = torch.zeros(lead, dtype=torch.int32, device=dev)
    qp_iters0 = torch.zeros(lead, dtype=torch.int32, device=dev)
    done0 = torch.zeros(lead, dtype=torch.bool, device=dev)
    stat0 = torch.full(lead, math.inf, **kw)
    feas0 = torch.full(lead, math.inf, **kw)
    empty_G = torch.zeros((N + 1, 0, nz), **kw)
    empty_g = torch.zeros((N + 1, 0), **kw)
    if one_shot:
        per_qp_budget = cfg.qp.max_iter if cfg.qp.max_iter is not None else 200
        qp_cfg_os = cfg.qp.replace(
            max_iter=cfg.max_iter * per_qp_budget,
            # in-kernel early exit on the SOLVER-level KKT criterion
            kkt_tols=(float(tol_stat), float(tol_feas)),
        )
        c0 = ocp.interval_residuals(W0)
        gm = ocp.cost_gradient(W0) * free
        zero_w = torch.zeros_like(W0)
        qp = StageQP(
            Hd=Hm_c, g=gm, J=Jm_c, K=Km_c, c=c0,
            G=empty_G, gl=empty_g, gu=empty_g,
            dlb=torch.where(free > 0, lb - W0, zero_w),
            dub=torch.where(free > 0, ub - W0, zero_w),
        )
        sol = solve_stage_qp(
            qp, qp_cfg_os,
            warm=QPWarmStart(
                delta=zero_w, y_dyn=y_dyn0, y_gen=y_gen0, y_box=y_box0,
            ),
        )
        W_os = W0 + sol.delta * free
        # exact KKT residuals of the NLP at the solution
        gm1 = ocp.cost_gradient(W_os) * free
        grad_lag = _grad_lagrangian(gm1, Jm_c, Km_c, sol.y_dyn, sol.y_box, free)
        stat0 = _amax2((grad_lag * free).abs())
        feas0 = _amax2(ocp.interval_residuals(W_os).abs())
        done0 = (stat0 < tol_stat) & (feas0 < tol_feas)
        # accept the one-shot iterate as the outer loop's starting point
        # either way: for converged lanes it is final (frozen by `done`);
        # for the rest it is a warm start strictly better than traj0.
        W0 = W_os
        y_dyn0, y_box0 = sol.y_dyn, sol.y_box
        it0 = torch.ones(lead, dtype=torch.int32, device=dev)
        qp_iters0 = sol.iters

    nu = torch.full(lead, cfg.merit_nu_init, **kw)
    ctx = SQPContext(
        ocp=ocp, cfg=cfg, lead=lead, tol_stat=tol_stat, tol_feas=tol_feas,
        free=free, lb=lb, ub=ub, alphas=alphas, hoisted=hoisted,
        hoist_JK=hoist_JK, hoist_H=hoist_H, clamp=clamp, one_shot=one_shot,
        empty_G=empty_G, empty_g=empty_g,
    )
    return ctx, SQPIterate(
        W=W0, y_dyn=y_dyn0, y_gen=y_gen0, y_box=y_box0, nu=nu, it=it0,
        stat=stat0, feas=feas0, done=done0, qp_tot=qp_iters0,
    )


def _sqp_more(ctx: SQPContext, s: SQPIterate) -> torch.Tensor:
    """True (a device tensor) while a lane is neither done nor out of budget."""
    return ((s.it < ctx.cfg.max_iter) & ~s.done).any()


def _sqp_trip(ctx: SQPContext, s: SQPIterate) -> SQPIterate:
    """One trip of the SQP loop over every lane. A lane that is done or out
    of budget is frozen: every update is ``torch.where(frozen, old, new)``,
    so a trip over lanes that are all frozen changes nothing."""
    ocp, cfg, free, lb, ub = ctx.ocp, ctx.cfg, ctx.free, ctx.lb, ctx.ub
    ng, lead, alphas = ocp.ng, ctx.lead, ctx.alphas
    Jm_c, Km_c, Hm_c = ctx.hoisted
    W, y_dyn, y_gen, y_box, nu = s.W, s.y_dyn, s.y_gen, s.y_box, s.nu
    it, done = s.it, s.done
    # ---- linearize (exact AD, all stages and lanes at once) ----
    if ctx.hoist_JK:
        Jm, Km = Jm_c, Km_c
        c = ocp.interval_residuals(W)
    else:
        J, K, c = ocp.interval_jacobians(W)
        Jm = J * free[:-1, None, :]
        Km = K * free[1:, None, :]
    grad = ocp.cost_gradient(W)
    Hm = Hm_c if ctx.hoist_H else _mask_hessian(
        ocp.cost_hessian_blocks(W), free, cfg.prox, ctx.clamp)

    # ---- pin masking: zero columns of fixed variables ----
    gm = grad * free
    zero_w = torch.zeros_like(W)
    Gm, gl, gu = ctx.empty_G, ctx.empty_g, ctx.empty_g
    if ng:
        r, rl, ru = ocp.general_rows(W)
        Gm = ocp.general_row_jacobians(W) * free[:, None, :]
        gl = torch.clamp(rl - r, min=-BIG)
        gu = torch.clamp(ru - r, max=BIG)
    qp = StageQP(
        Hd=Hm, g=gm, J=Jm, K=Km, c=c, G=Gm, gl=gl, gu=gu,
        dlb=torch.where(free > 0, lb - W, zero_w),
        dub=torch.where(free > 0, ub - W, zero_w),
    )
    sol = solve_stage_qp(
        qp, cfg.qp,
        warm=QPWarmStart(delta=zero_w, y_dyn=y_dyn, y_gen=y_gen, y_box=y_box),
    )
    delta = sol.delta * free

    # ---- ℓ1 merit line search (parallel candidates) ----
    with span("sqp.line_search"):
        y_max = _amax2(sol.y_dyn.abs())
        if ng:
            y_max = torch.maximum(y_max, _amax2(sol.y_gen.abs()))
        # ν tracks the current dual scale both ways: it must dominate the
        # duals for the ℓ1 merit to be exact, but a ν stuck at the scale of
        # the FIRST iterations' duals over-penalizes residual infeasibility
        # near the solution; geometric decay forgets stale magnitudes.
        nu_new = torch.maximum(1.2 * y_max + 1e-3, 0.5 * nu)
        phi0, infeas0 = _merit(ocp, W, lb, ub, nu_new, free)
        dirderiv = (grad * delta).sum(dim=(-2, -1)) - nu_new * infeas0

        # candidates in a new leading dim: [n_cand, *lead, N+1, nz]
        a_w = alphas.reshape((-1,) + (1,) * (len(lead) + 2))
        a_l = alphas.reshape((-1,) + (1,) * len(lead))
        phis, infeas_c = _merit(ocp, W + a_w * delta, lb, ub, nu_new, free)
        ok = phis <= phi0 + cfg.ls_c1 * a_l * torch.clamp(dirderiv, max=0.0)
        any_ok = ok.any(dim=0)
        idx = ok.to(torch.int8).argmax(dim=0)  # first True = largest α
        # Maratos watchdog: accept the FULL step whenever the merit test
        # fails across the board yet the trial point stays essentially
        # feasible, i.e. the rejection is second-order noise, not a real
        # feasibility loss.
        rescue = (
            (~any_ok)
            & (infeas0 <= cfg.rescue_infeas_max)
            & (infeas_c[0] <= torch.clamp(10.0 * infeas0, min=ctx.tol_feas))
        )
        alpha = torch.where(
            any_ok, alphas[idx], torch.where(rescue, alphas[0], alphas[-1])
        )
        step = alpha[..., None, None] * delta
        W_new = W + step

    # ---- KKT residuals (at current linearization, QP multipliers) ----
    grad_lag = _grad_lagrangian(gm, Jm, Km, sol.y_dyn, sol.y_box, free)
    feas_n = _amax2(c.abs())
    if ng:
        grad_lag = grad_lag + torch.einsum("...kri,...kr->...ki", Gm, sol.y_gen)
        viol = torch.clamp(rl - r, min=0.0) + torch.clamp(r - ru, min=0.0)
        feas_n = torch.maximum(feas_n, _amax2(viol))
    stat_n = _amax2((grad_lag * free).abs())
    step_norm = _amax2(step.abs())
    converged = ((stat_n < ctx.tol_stat) & (feas_n < ctx.tol_feas)) | (
        (step_norm < 1e-12) & (feas_n < ctx.tol_feas)
    )
    # freeze finished lanes: the loop runs until ALL lanes finish, and
    # extra iterations must not move a lane that already satisfied its
    # KKT tolerances (or spent its budget)
    frozen = done | (it >= cfg.max_iter)
    f2 = frozen[..., None, None]
    return SQPIterate(
        W=torch.where(f2, W, W_new),
        y_dyn=torch.where(f2, y_dyn, sol.y_dyn),
        y_gen=torch.where(f2, y_gen, sol.y_gen),
        y_box=torch.where(f2, y_box, sol.y_box),
        stat=torch.where(frozen, s.stat, stat_n),
        feas=torch.where(frozen, s.feas, feas_n),
        it=torch.where(frozen, it, it + 1),
        qp_tot=torch.where(frozen, s.qp_tot, s.qp_tot + sol.iters),
        done=torch.where(frozen, done, converged),
        nu=torch.where(frozen, nu, nu_new),
    )


def _count_work(ctx: SQPContext, it: torch.Tensor, trips: int) -> None:
    """A solve's lock-step iterations (the one-shot and ``trips`` loop
    trips), its useful lane iterations (the per-lane ``it``, kept by
    reference) and the slots lock step gave the lanes."""
    lockstep = int(ctx.one_shot) + trips
    count("sqp.lockstep_iters", lockstep)
    count("sqp.lane_iters", it)
    count("sqp.lane_slots", math.prod(ctx.lead) * lockstep)


def sqp_finish(ctx: SQPContext, s: SQPIterate) -> SQPResult:
    """The status of every lane and the ``SQPResult``."""
    status = torch.where(
        s.done,
        torch.full_like(s.it, int(SolverStatus.CONVERGED)),
        torch.full_like(s.it, int(SolverStatus.EARLY_TERMINATED)),
    )
    return SQPResult(
        traj=ctx.ocp.unpack(s.W), W=s.W, y_dyn=s.y_dyn, y_gen=s.y_gen, y_box=s.y_box,
        iterations=s.it, objective=ctx.ocp.objective_from_W(s.W),
        stat_res=s.stat, feas_res=s.feas, status=status, qp_iters=s.qp_tot,
    )
