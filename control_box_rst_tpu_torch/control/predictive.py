"""Predictive (MPC) controller, batch-first.

Counterpart of the JAX package's ``control/predictive.py``. Per control step
the controller shifts its warm start (primal W and duals) by the
state-proximity count of each lane, overwrites the x0 row with the measured
state, restores pinned terminal components, solves the OCP warm-started
(SQP; interior point or Levenberg-Marquardt on the primal only), and keeps
the UNSHIFTED
solution in the carry: the next step shifts it with the state it measures.

The reference runs one plant per call under ``vmap``; here every function
takes a batch of lanes (W [B, N+1, nz], x [B, nx]) and every per-lane choice
(the shift count, the clamp of the shifted controls to the active horizon,
the dual reset after an unusable solve) is a ``torch.where`` or a gather over
lanes, never a Python branch on a batch.

The controller is built for one device and dtype: the OCP is moved there
once, at construction, and each step only replaces its initial state. When
the problem is LTI with a constant Hessian (``ocp.lti_structure`` and
``ocp.constant_hessian``: linear dynamics, dt pinned, quadratic cost), the
interval Jacobians J, K and the Hessian blocks Hd do not depend on the
iterate, so they are evaluated once, at construction, from the unbatched
initial guess, and every SQP solve gets them (``hoisted=``): the fused box-QP
kernel then reads one shared copy for the whole batch.

With a grid adaptation (``ocp/adaptation.py``) every lane carries its own
active horizon ``n_active``: each step first adapts each lane's warm start
and horizon, then solves with the per-lane stage mask of those horizons.
The structure then changes with the mask at every step and differs from lane
to lane, so nothing is hoisted: every SQP iteration linearizes every lane.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from control_box_rst_tpu_torch.control.base import Controller, ControlOutput
from control_box_rst_tpu_torch.ocp.adaptation import stage_mask_from_n
from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.ocp.transcribe import TranscribedOCP
from control_box_rst_tpu_torch.solvers.ip import IPConfig, ip_solve
from control_box_rst_tpu_torch.solvers.lm import LMConfig, lm_solve
from control_box_rst_tpu_torch.solvers.sqp import (
    SQPConfig,
    SQPHoisted,
    SQPResult,
    SQPWarmStart,
    hoist_structure,
    resolve_qp_backend,
    sqp_solve,
)
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype
from control_box_rst_tpu_torch.utils.profiling import span
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


class MPCCarry(NamedTuple):
    """Warm-start state of a batch of MPC lanes."""

    W: torch.Tensor        # [B, N+1, nz] primal warm start
    y_dyn: torch.Tensor    # [B, N, nc]
    y_gen: torch.Tensor    # [B, N+1, ng]
    y_box: torch.Tensor    # [B, N+1, nz]
    u_prev: torch.Tensor   # [B, nu] last applied control
    n_active: torch.Tensor  # [B] int32 active interval count
    feas_prev: torch.Tensor  # [B] previous solve's constraint violation


def find_nearest_state(
    W: torch.Tensor, x0: torch.Tensor, nx: int, lookahead: int = 20,
    n_active=None,
) -> torch.Tensor:
    """State-proximity shift count of every lane: the index of the nearest
    already-planned state to the new x0, by the reference's greedy forward
    walk (stop at the first non-decreasing distance).

    W [..., N+1, nz], x0 [..., nx], ``n_active`` [...] or a number → k [...]
    int32. At most L = min(lookahead, N−1) samples ahead (at least one
    interval is kept); 0 when the start state is unchanged. With a masked
    horizon the distances past the last active stage are +inf, so the walk
    never enters the inactive tail."""
    N = W.shape[-2] - 1
    L = min(lookahead, N - 1)
    d = torch.linalg.vector_norm(W[..., : L + 1, :nx] - x0[..., None, :], dim=-1)
    if n_active is not None:
        idx = torch.arange(L + 1, device=W.device)
        n = torch.as_tensor(n_active, device=W.device)[..., None]
        d = torch.where(idx <= n - 1, d, torch.full_like(d, float("inf")))
    zero = torch.zeros(d.shape[:-1], dtype=torch.int32, device=W.device)
    if L < 1:
        return zero
    inc = d[..., 1:] >= d[..., :-1]  # True where the walk would stop
    # argmax is not defined on bool; torch returns the first maximal index
    first_stop = inc.to(torch.int8).argmax(dim=-1).to(torch.int32)
    nearest = torch.where(inc.any(dim=-1), first_stop, torch.full_like(first_stop, L))
    return torch.where(d[..., 0] < 1e-12, zero, nearest)


def _shift_index(n: int, num_shift, device) -> torch.Tensor:
    """[..., n] stage index i + k of every lane (k [...] or a number)."""
    k = torch.as_tensor(num_shift, device=device).to(torch.int64)
    return torch.arange(n, device=device) + k[..., None]


def shift_warm_start(W: torch.Tensor, nx: int, num_shift=1, n_active=None) -> torch.Tensor:
    """Moving-horizon shift of every lane by its own count k (``num_shift``
    [...] or a number): stage i takes old stage i+k; tail states extrapolate
    along the last planned interval (x_N + over·(x_N − x_{N−1}) for a stage
    ``over`` past the end); controls and dt hold the last real interval
    (n_active − 1, or N − 1); stage N's control/dt row is 0. k = 0 is the
    identity."""
    N = W.shape[-2] - 1
    idx = _shift_index(N + 1, num_shift, W.device)
    lead = torch.broadcast_shapes(W.shape[:-2], idx.shape[:-1])
    W = W.expand(lead + W.shape[-2:])
    idx = idx.expand(lead + idx.shape[-1:])
    over = torch.clamp(idx - N, min=0)
    X, rest = W[..., :nx], W[..., nx:]
    XN, XN1 = X[..., N, :], X[..., N - 1, :]
    x_ext = XN[..., None, :] + over[..., None].to(X.dtype) * (XN - XN1)[..., None, :]
    x_gat = torch.take_along_dim(X, torch.clamp(idx, max=N)[..., None], dim=-2)
    x_shift = torch.where((over > 0)[..., None], x_ext, x_gat)
    if n_active is None:
        last_real = torch.full(lead, N - 1, dtype=torch.int64, device=W.device)
    else:
        last_real = torch.as_tensor(n_active, device=W.device).to(torch.int64) - 1
        last_real = last_real.expand(lead)
    rest_shift = torch.take_along_dim(
        rest, torch.minimum(idx, last_real[..., None])[..., None], dim=-2)
    rest_shift[..., -1, :] = 0.0
    return torch.cat([x_shift, rest_shift], dim=-1)


def shift_stage_rows(a: torch.Tensor, num_shift, last: int) -> torch.Tensor:
    """Shift stage-indexed rows (duals) of every lane by its own count,
    duplicating the row at index ``last`` for the tail."""
    idx = torch.clamp(_shift_index(a.shape[-2], num_shift, a.device), max=last)
    lead = torch.broadcast_shapes(a.shape[:-2], idx.shape[:-1])
    a = a.expand(lead + a.shape[-2:])
    idx = idx.expand(lead + idx.shape[-1:])
    return torch.take_along_dim(a, idx[..., None], dim=-2)


_SOLVERS = ("sqp", "ip", "lm")


@plain_dataclass
class PredictiveController(Controller):
    """MPC controller over a TranscribedOCP, for a batch of plants.

    ``solver``: 'sqp' (warm-started primal and duals; ``num_ocp_iterations``
    solves per step), 'ip' (the interior-point solver from the primal warm
    start, its duals re-centred every step; the carry takes its duals, the
    bound duals as y_box = z_uw − z_lw) or 'lm' (Levenberg-Marquardt on the
    primal warm start; the carry's duals pass through unchanged).
    ``adaptation``: a ``GridAdaptation`` applied at the start of every step
    from the previous solve's constraint violation; ``n_active_init``: the
    initial active horizon (0: the grid's N); ``warm_start_shift=False``
    keeps the previous solution in place instead of shifting it by the
    state-proximity count.
    ``cfg.qp.backend=None`` resolves to 'fused' for a float32 solve without
    general rows on the card, else to 'plain'. A solve is usable (``ok``)
    when its constraint violation is below ``usable_feas_tol``; the duals of
    an unusable solve are reset to zero, lane by lane.

    ``device`` (``None`` means the card and raises when there is none) and
    ``dtype`` (``None`` means float32) are where the controller runs; the OCP
    is moved there at construction, and the carry and the states given to
    ``step`` live there."""

    ocp: TranscribedOCP = None
    dt: float = 0.1  # grid dt (fixed grids) / initial dt guess (variable)
    cfg: SQPConfig = None
    solver: str = "sqp"
    ip_cfg: IPConfig = None
    lm_cfg: LMConfig = None
    num_ocp_iterations: int = 1
    warm_start_shift: bool = True
    n_active_init: int = 0
    adaptation: object = None
    usable_feas_tol: float = 1e-3
    device: object = None
    dtype: object = None
    # derived at construction
    sqp_cfg: SQPConfig = dataclasses.field(default=None, init=False, repr=False)
    hoisted: Optional[SQPHoisted] = dataclasses.field(default=None, init=False, repr=False)

    def __post_init__(self):
        set_ = lambda k, v: object.__setattr__(self, k, v)
        if self.solver not in _SOLVERS:
            raise KeyError(f"unknown solver {self.solver!r}; have {list(_SOLVERS)}")
        if self.num_ocp_iterations < 1:
            raise ValueError("num_ocp_iterations must be >= 1")
        device, dtype = resolve_device(self.device), resolve_dtype(self.dtype)
        set_("device", device)
        set_("dtype", dtype)
        if self.cfg is None:
            set_("cfg", SQPConfig())
        if self.solver == "ip" and self.ip_cfg is None:
            set_("ip_cfg", IPConfig())
        if self.solver == "lm" and self.lm_cfg is None:
            set_("lm_cfg", LMConfig())
        ocp = self.ocp.to(device=device, dtype=dtype)
        set_("ocp", ocp)
        cfg = resolve_qp_backend(self.cfg, ocp.ng, device, dtype)
        set_("sqp_cfg", cfg)
        if self.solver == "sqp":
            # J, K, Hd of an LTI problem with a constant Hessian, once, from
            # the unbatched initial guess (SQPHoisted(None, None, None) when
            # they depend on the iterate, or on a lane's adapted horizon)
            hoisted = SQPHoisted(None, None, None)
            if self.adaptation is None:
                hoisted = hoist_structure(ocp, self._initial_guess(ocp.bc.x0), cfg)
            set_("hoisted", hoisted)

    @property
    def horizon(self) -> int:
        return self.ocp.N

    def to(self, device=None, dtype=None) -> "PredictiveController":
        """The controller rebuilt for ``device`` / ``dtype`` (``None``: the
        card, float32): the OCP moved there and the structure hoisted again."""
        return self.replace(device=device, dtype=dtype)

    def _initial_guess(self, x0: torch.Tensor) -> Trajectory:
        """Straight line x0 → xf, zero controls, dt = ``self.dt`` (clipped to
        the dt bounds of a variable-dt grid)."""
        ocp = self.ocp
        xf = ocp.bc.xf if ocp.bc.xf is not None else ocp.refs.xref[-1]
        dt0 = torch.as_tensor(self.dt, dtype=self.dtype, device=self.device)
        if ocp.grid.dt_is_variable:
            b = ocp.bounds
            dt0 = torch.clamp(
                dt0,
                torch.where(torch.isfinite(b.dt_lb), b.dt_lb, dt0),
                torch.where(torch.isfinite(b.dt_ub), b.dt_ub, dt0),
            )
        return Trajectory.linear_interp(x0, xf, ocp.N, ocp.nu, float(dt0))

    def init_carry(self, x0: torch.Tensor) -> MPCCarry:
        """Carry of a batch of lanes starting at x0 [B, nx]."""
        ocp = self.ocp
        x0 = x0.to(device=self.device, dtype=self.dtype)
        N, nz, nc, ng = ocp.N, ocp.nz, ocp.nc, ocp.ng
        lead = tuple(x0.shape[:-1])
        W = ocp.pack(self._initial_guess(x0))
        kw = dict(dtype=self.dtype, device=self.device)
        return MPCCarry(
            W=W,
            y_dyn=torch.zeros(lead + (N, nc), **kw),
            y_gen=torch.zeros(lead + (N + 1, ng), **kw),
            y_box=torch.zeros(lead + (N + 1, nz), **kw),
            u_prev=torch.zeros(lead + (ocp.nu,), **kw),
            n_active=torch.full(lead, self.n_active_init or N, dtype=torch.int32,
                                device=self.device),
            feas_prev=torch.zeros(lead, **kw),
        )

    @span("controller.step")
    def step(self, carry: MPCCarry, x: torch.Tensor, t, dt) -> tuple:
        """One MPC step of every lane from the measured states x [B, nx]:
        ``step_prefix``, the solve, ``step_suffix``."""
        ocp, n_active, warm = self.step_prefix(carry, x)
        traj_init = ocp.unpack(warm.W)
        if self.solver == "lm":
            lm_res = lm_solve(ocp, traj_init, self.lm_cfg)
            # LM carries no duals: the carry's pass through unchanged
            iterations = lm_res.iterations
            solved = Solved(
                W=lm_res.W, traj=lm_res.traj, feas=lm_res.feas_res, y_dyn=warm.y_dyn,
                y_gen=warm.y_gen, y_box=warm.y_box,
                objective=ocp.objective_from_W(lm_res.W), iterations=iterations,
                stat=lm_res.chi2, qp_iters=torch.zeros_like(iterations))
        elif self.solver == "ip":
            res = ip_solve(ocp, traj_init, self.ip_cfg)
            # the bound duals in the SQP's signed-box convention (positive:
            # pushing against the upper bound)
            solved = Solved(
                W=res.W, traj=res.traj, feas=res.feas_res, y_dyn=res.y_dyn,
                y_gen=res.y_gen, y_box=res.z_uw - res.z_lw, objective=res.objective,
                iterations=res.iterations, stat=res.stat_res,
                qp_iters=torch.zeros_like(res.iterations))
        else:
            for _ in range(self.num_ocp_iterations):
                res = sqp_solve(ocp, traj_init, self.sqp_cfg, warm=warm, hoisted=self.hoisted)
                warm = SQPWarmStart(W=res.W, y_dyn=res.y_dyn, y_gen=res.y_gen, y_box=res.y_box)
                traj_init = res.traj
            solved = solved_by_sqp(res)
        return self.step_suffix(n_active, solved)

    def step_prefix(self, carry: MPCCarry, x: torch.Tensor):
        """The step up to the solve: the grid adaptation, the warm start
        shifted by each lane's state-proximity count, the x0 row and the
        pinned terminal components. Returns (the OCP from x, each lane's
        active horizon, the warm start)."""
        ocp = self.ocp.replace(bc=self.ocp.bc.replace(x0=x))
        nx, N = ocp.nx, ocp.N
        W, y_dyn, y_gen, y_box = carry.W, carry.y_dyn, carry.y_gen, carry.y_box
        n_active = carry.n_active
        if self.adaptation is not None:
            # adapt every lane's grid before the solve, from the previous
            # solve's constraint violation; the lane's horizon becomes its mask
            W, n_active = self.adaptation.adapt(
                W, n_active, nx, ocp.nu, N, feas=carry.feas_prev)
            ocp = ocp.replace(
                stage_mask=stage_mask_from_n(n_active, N, W.dtype, W.device))
        if self.warm_start_shift:
            # moving-horizon shift at the START of the step with the measured
            # state (the reference's call order): the count is however many
            # planned states the plant passed, lane by lane, inside its
            # active horizon
            k = find_nearest_state(W, x, nx, n_active=n_active)
            W = shift_warm_start(W, nx, k, n_active=n_active)
            y_dyn = shift_stage_rows(y_dyn, k, N - 1)
            y_gen = shift_stage_rows(y_gen, k, N)
            y_box = shift_stage_rows(y_box, k, N)
        else:
            W = W.clone()
        # overwrite the x0 row, keep the rest of the warm start
        W[..., 0, :nx] = x
        # restore pinned terminal components: the tail extrapolation writes
        # through the goal state, and a pinned vertex keeps what it holds
        if ocp.bc.xf_fixed is not None and ocp.bc.xf is not None:
            mask = ocp.bc.xf_fixed.to(W.dtype)
            W[..., -1, :nx] = mask * ocp.bc.xf + (1.0 - mask) * W[..., -1, :nx]
        return ocp, n_active, SQPWarmStart(W=W, y_dyn=y_dyn, y_gen=y_gen, y_box=y_box)

    def step_suffix(self, n_active: torch.Tensor, solved: Solved) -> tuple:
        """The step after the solve: the duals of an unusable solve reset,
        the new carry and the ``ControlOutput``."""
        # duals of an unusable solve are no warm start (ADMM on an
        # infeasible QP grows them without bound): reset, lane by lane
        feas, traj = solved.feas, solved.traj
        usable = feas < self.usable_feas_tol
        u2 = usable[..., None, None]
        y_dyn = torch.where(u2, solved.y_dyn, torch.zeros_like(solved.y_dyn))
        y_gen = torch.where(u2, solved.y_gen, torch.zeros_like(solved.y_gen))
        y_box = torch.where(u2, solved.y_box, torch.zeros_like(solved.y_box))
        u0 = traj.U[..., 0, :]
        new_carry = MPCCarry(
            W=solved.W, y_dyn=y_dyn, y_gen=y_gen, y_box=y_box, u_prev=u0,
            n_active=n_active, feas_prev=feas,
        )
        out = ControlOutput(
            u=u0, u_seq=traj.U, x_seq=traj.X, ok=usable,
            info={
                "objective": solved.objective,
                "sqp_iters": solved.iterations,
                "qp_iters": solved.qp_iters,
                "stat_res": solved.stat,
                "feas_res": feas,
                "dts": traj.dts,
                "n_active": n_active,
            },
        )
        return new_carry, out


class Solved(NamedTuple):
    """What a controller step takes from its solver, whichever it is."""

    W: torch.Tensor
    traj: Trajectory
    feas: torch.Tensor
    y_dyn: torch.Tensor
    y_gen: torch.Tensor
    y_box: torch.Tensor
    objective: torch.Tensor
    iterations: torch.Tensor
    stat: torch.Tensor
    qp_iters: torch.Tensor


def solved_by_sqp(res: SQPResult) -> Solved:
    return Solved(
        W=res.W, traj=res.traj, feas=res.feas_res, y_dyn=res.y_dyn, y_gen=res.y_gen,
        y_box=res.y_box, objective=res.objective, iterations=res.iterations,
        stat=res.stat_res, qp_iters=res.qp_iters)
