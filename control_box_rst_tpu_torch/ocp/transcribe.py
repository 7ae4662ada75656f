"""Transcription: grid + system + costs → canonical stage NLP.

Counterpart of the JAX package's ``ocp/transcribe.py``.

Canonical form ("stage NLP"): decision variables are W ∈ [N+1, nz] with
w_k = [x_k ; u_k ; dt_k] (nz = nx+nu+1; unused components are pinned via
``fixed_mask``), and on the uncompressed Hermite-Simpson grid the interval
midpoint state appended, w_k = [x_k ; u_k ; dt_k ; xm_k] (``n_aux`` = nx).
The NLP is

  min  Σ_{k<N} stage_term_k(w_k, w_{k+1})  +  final(x_N)
  s.t. c_k(w_k, w_{k+1}) = 0                      k < N   (defect + tie rows)
       r_k(w_k) ∈ [rl_k, ru_k]                    k ≤ N   (general rows)
       lb_k ≤ w_k ≤ ub_k                                   (box; pins incl.)

Batch-first: W may carry leading dims ([B, N+1, nz]); every per-stage
function takes its stage data (w_k, w_{k+1}, references, mask) as operands
that broadcast over leading dims, so one call evaluates all stages of all
lanes as plain tensor ops. Derivatives stay exact: the interval Jacobians and
the Hessian blocks come from ``torch.func.jacfwd`` / ``hessian`` vmapped over
stages (for config 1 they are constant and the solver evaluates them once per
batch), and the cost gradient of all lanes comes from one
``torch.autograd.grad`` of the summed objective — lanes are independent, so
the gradient of the sum is every lane's own gradient.

Variable-horizon support: ``stage_mask[..., k] ∈ {0,1}`` deactivates tail
intervals by replacing their defect with the identity chain x_{k+1} − x_k = 0
and zeroing their cost, so only array values change, never shapes. The mask
is [N] (every lane the same horizon) or [..., N], one horizon per lane (grid
adaptation, ``ocp/adaptation.py``); a per-lane mask batches every evaluation
over its lanes, whether W carries them or not.

General rows: a ``StageConstraint`` gives every interval k < N its rows
(multiplied by the stage mask, per lane where the mask is), a
``TerminalConstraint`` gives stage N its rows; both are padded to the common
width ng = max(ng_stage, ng_term). Equality rows have bounds [0, 0],
inequality rows (−inf, 0], padding rows (−inf, +inf).

Interval rows: the defect of the grid's scheme (every FD scheme, the
linear-control Hermite-Simpson scheme reading the next stage's control, the
uncompressed Hermite-Simpson rows with their midpoint tie, multiple
shooting), then tie rows: dt_{k+1} − dt_k = 0 for k < N−1 on a grid with one
dt tied across the intervals, and u_{k+1} − u_k = 0 inside each block of a
move-blocking grid (its last interval's rows are zero). nc = nx + n_aux +
n_tie. Cost integration: left sum, trapezoidal, Hermite-Simpson (with the
Hermite midpoint, piecewise-constant or linear control) and Simpson on the
decision midpoint. Integrators the port does not carry are refused at
construction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from control_box_rst_tpu_torch.models.base import SystemDynamics
from control_box_rst_tpu_torch.ocp.costs import StageCost
from control_box_rst_tpu_torch.ocp.grids import Grid
from control_box_rst_tpu_torch.ocp.problem import (
    BoundaryConditions,
    Bounds,
    References,
    Trajectory,
)
from control_box_rst_tpu_torch.ops.collocation import (
    get_fd_collocation,
    hermite_simpson_lc_defect,
    hermite_simpson_unc_rows,
)
from control_box_rst_tpu_torch.ops.integrators import make_integrator
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype
from control_box_rst_tpu_torch.utils.profiling import span
from control_box_rst_tpu_torch.utils.tree import plain_dataclass, tree_to

_COST_INTEGRATIONS = ("left_sum", "trapezoidal", "hermite_simpson",
                      "hermite_simpson_lc", "hermite_simpson_unc")
# cost integrations whose interval term reads x_{k+1}: the Hessian block of
# stage k then sums the terms of intervals k and k−1
_COUPLED_INTEGRATIONS = _COST_INTEGRATIONS[1:]
# schemes the transcription evaluates itself (not through get_fd_collocation)
_OWN_SCHEMES = ("hermite_simpson_lc", "hermite_simpson_unc")
_DT_MODES = ("fixed", "single", "per_interval")

def _vmap_over_lead(fn, lead_ndim: int, n_batched: int, n_shared: int):
    """vmap ``fn`` (already vmapped over stages) over ``lead_ndim`` leading
    batch dims of its first ``n_batched`` arguments."""
    in_dims = (0,) * n_batched + (None,) * n_shared
    for _ in range(lead_ndim):
        fn = torch.func.vmap(fn, in_dims=in_dims)
    return fn


@plain_dataclass
class TranscribedOCP:
    """A fully-specified stage NLP."""

    grid: Grid = None
    system: SystemDynamics = None
    cost: StageCost = None
    stage_con: Optional[object] = None
    term_con: Optional[object] = None
    bounds: Bounds = None
    bc: BoundaryConditions = None
    refs: References = None
    stage_mask: torch.Tensor = None  # [N] or [..., N] 1.0 = interval active
    # [N] 1.0 where interval k carries a dt tie row: k < N−1 (the last
    # interval would tie the real dt to stage N's dummy dt). The same for
    # every lane; made here from ``stage_mask``'s device and dtype, and made
    # again whenever a ``replace`` or ``to`` changes N, the device or the dtype.
    tie_mask: Optional[torch.Tensor] = None
    # [N, nu] 1.0 where interval k ties u_{k+1} to u_k inside a move-blocking
    # block (the last row zero; all zero without move blocking). Made like
    # ``tie_mask``, and again whenever a ``replace`` changes the grid.
    u_tie_mask: Optional[torch.Tensor] = None

    def __post_init__(self):
        g, m, t = self.grid, self.stage_mask, self.tie_mask
        if (t is None or t.shape != (g.N,) or t.device != m.device
                or t.dtype != m.dtype):
            object.__setattr__(
                self, "tie_mask",
                (torch.arange(g.N, device=m.device) < g.N - 1).to(m.dtype))
        ut, nu = self.u_tie_mask, self.system.nu
        if (ut is None or ut.shape != (g.N, nu) or ut.device != m.device
                or ut.dtype != m.dtype):
            # raises on a bad block sequence
            rows = np.concatenate([g.u_tie_mask(nu), np.zeros((1, nu))])
            object.__setattr__(
                self, "u_tie_mask",
                torch.as_tensor(rows).to(device=m.device, dtype=m.dtype)
                if g.has_u_tie else torch.zeros((g.N, nu), device=m.device, dtype=m.dtype))
        if g.kind not in ("fd", "ms"):
            raise ValueError(f"unknown grid kind {g.kind!r}")
        if self.system.continuous_time:
            # raise for unknown schemes and integrators
            if g.kind == "fd":
                if g.fd_scheme not in _OWN_SCHEMES:
                    get_fd_collocation(g.fd_scheme)
            else:
                make_integrator(g.integrator, g.integrator_substeps)
        if g.dt_mode not in _DT_MODES:
            raise ValueError(f"unknown dt_mode {g.dt_mode!r}; have {list(_DT_MODES)}")
        if self.cost.integral and g.cost_integration not in _COST_INTEGRATIONS:
            raise KeyError(
                f"unknown cost integration {g.cost_integration!r}; "
                f"have {list(_COST_INTEGRATIONS)}"
            )
        if g.cost_integration == "hermite_simpson_unc" and self.cost.integral \
                and not self.n_aux:
            raise ValueError(
                "cost integration 'hermite_simpson_unc' needs the midpoint slots "
                "of the uncompressed Hermite-Simpson grid (a continuous-time system)")

    # ---------------- dimensions ----------------
    @property
    def N(self) -> int:
        return self.grid.N

    @property
    def nx(self) -> int:
        return self.system.nx

    @property
    def nu(self) -> int:
        return self.system.nu

    @property
    def n_aux(self) -> int:
        """Auxiliary per-stage decision states appended after [x;u;dt]: the
        uncompressed Hermite-Simpson scheme stores interval k's midpoint
        state in stage k, which keeps every interval row coupled to two
        stages (and the KKT system block-tridiagonal)."""
        g = self.grid
        unc = g.kind == "fd" and g.fd_scheme == "hermite_simpson_unc"
        return self.nx if unc and self.system.continuous_time else 0

    @property
    def nz(self) -> int:
        return self.nx + self.nu + 1 + self.n_aux

    @property
    def n_tie(self) -> int:
        """Tie rows per interval: one for a dt tied across the intervals, nu
        for move blocking."""
        return (1 if self.grid.has_dt_tie else 0) + (
            self.nu if self.grid.has_u_tie else 0)

    @property
    def nc(self) -> int:
        """Interval equality rows: defect (+ midpoint ties) + ties."""
        return self.nx + self.n_aux + self.n_tie

    @property
    def ng_stage(self) -> int:
        sc = self.stage_con
        return 0 if sc is None else sc.neq + sc.nineq

    @property
    def ng_term(self) -> int:
        tc = self.term_con
        return 0 if tc is None else tc.neq + tc.nineq

    @property
    def ng(self) -> int:
        """General rows per stage: stage rows at k < N, terminal rows at N."""
        return max(self.ng_stage, self.ng_term)

    @property
    def per_lane_mask(self) -> bool:
        """True when the stage mask carries lane dims (one horizon per lane)."""
        return self.stage_mask.dim() > 1

    def with_mask_lanes(self, W: torch.Tensor) -> torch.Tensor:
        """W with the lane dims of W and of a per-lane stage mask (a copy
        per lane where the mask adds lanes: forward-mode AD writes its
        tangents into W's memory)."""
        lead = torch.broadcast_shapes(W.shape[:-2], self.stage_mask.shape[:-1])
        if lead == W.shape[:-2]:
            return W
        return W.expand(lead + W.shape[-2:]).contiguous()

    # ---------------- packing ----------------
    def pack(self, traj: Trajectory) -> torch.Tensor:
        """Trajectory → W [..., N+1, nz]. Stage N gets dummy u/dt (zeros).
        X, U and dts may carry different leading dims; they broadcast. The
        midpoint slots (uncompressed Hermite-Simpson) start at the linear
        midpoints (x_k + x_{k+1})/2, stage N's at x_N; from then on they are
        decision variables of W."""
        X, U, dts = traj.X, traj.U, traj.dts
        lead = torch.broadcast_shapes(X.shape[:-2], U.shape[:-2], dts.shape[:-1])
        X = X.expand(lead + X.shape[-2:])
        U = U.expand(lead + U.shape[-2:])
        dts = dts.expand(lead + dts.shape[-1:])
        U_pad = torch.cat([U, U.new_zeros(lead + (1, self.nu))], dim=-2)
        dt_pad = torch.cat([dts, dts.new_zeros(lead + (1,))], dim=-1)
        cols = [X, U_pad, dt_pad[..., None]]
        if self.n_aux:
            Xm = 0.5 * (X[..., :-1, :] + X[..., 1:, :])
            cols.append(torch.cat([Xm, X[..., -1:, :]], dim=-2))
        return torch.cat(cols, dim=-1)

    def unpack(self, W: torch.Tensor) -> Trajectory:
        nx, nu = self.nx, self.nu
        return Trajectory(
            X=W[..., :, :nx], U=W[..., :-1, nx:nx + nu], dts=W[..., :-1, nx + nu]
        )

    @staticmethod
    def split_w(w: torch.Tensor, nx: int, nu: int):
        return w[..., :nx], w[..., nx:nx + nu], w[..., nx + nu]

    # ---------------- defect ----------------
    def _reads_next_control(self) -> bool:
        """Does the defect read the next stage's control? Only the
        linear-control Hermite-Simpson scheme does."""
        g = self.grid
        return (g.kind == "fd" and g.fd_scheme == "hermite_simpson_lc"
                and self.system.continuous_time)

    def _defect_fn(self):
        """Returns defect(x, u, x1, u1, dt) for the grid's scheme; ``u1`` is
        the next stage's control, which only the linear-control
        Hermite-Simpson scheme reads."""
        g = self.grid
        f = self.system
        if not f.continuous_time:
            # discrete-time system: x⁺ = f(x, u); one-step defect, both kinds
            return lambda x, u, x1, u1, dt: f(x, u) - x1
        if g.kind == "ms":
            integ = make_integrator(g.integrator, g.integrator_substeps)
            return lambda x, u, x1, u1, dt: integ.solve_ivp(f, x, u, dt) - x1
        if g.fd_scheme == "hermite_simpson_lc":
            return lambda x, u, x1, u1, dt: hermite_simpson_lc_defect(f, x, u, x1, u1, dt)
        scheme = get_fd_collocation(g.fd_scheme)
        return lambda x, u, x1, u1, dt: scheme(f, x, u, x1, dt)

    def interval_residual(self, w, w1, m, tie, utie):
        """c_k(w_k, w_{k+1}) ∈ R^nc: masked defect + tie rows. ``w``, ``w1``
        [..., nz] are the two stages of an interval, ``m`` [...] its
        stage-mask entry, ``tie`` [...] its ``tie_mask`` entry (k < N−1),
        ``utie`` [..., nu] its row of ``u_tie_mask``."""
        nx, nu = self.nx, self.nu
        x, u, dt = self.split_w(w, nx, nu)
        x1 = w1[..., :nx]
        # guard: inactive intervals may carry dt = 0, and FD defects divide
        # by dt — evaluate them at a safe dt (the result is masked out)
        dt_safe = torch.where(m > 0, dt, torch.ones_like(dt))
        mm = m[..., None]
        if self.n_aux:
            xm = w[..., nx + nu + 1:]
            unc = hermite_simpson_unc_rows(self.system, x, xm, u, x1, dt_safe)
            # inactive interval → identity chain, midpoint pinned to x
            idle = torch.cat([x1 - x, xm - x], dim=-1)
            rows = [mm * unc + (1.0 - mm) * idle]
        else:
            u1 = u
            if self._reads_next_control():
                # the next stage's control; the last interval takes its own
                # (stage N carries a pinned dummy control)
                t1 = tie[..., None]
                u1 = t1 * w1[..., nx:nx + nu] + (1.0 - t1) * u
            defect = self._defect_fn()(x, u, x1, u1, dt_safe)
            # inactive interval → identity chain (keeps the tail pinned)
            rows = [mm * defect + (1.0 - mm) * (x1 - x)]
        if self.grid.has_dt_tie:
            dt1 = w1[..., nx + nu]
            rows.append((tie * (dt1 - dt))[..., None])
        if self.grid.has_u_tie:
            rows.append(utie * (w1[..., nx:nx + nu] - u))
        return torch.cat(rows, dim=-1) if len(rows) > 1 else rows[0]

    @span("transcription.interval_residuals")
    def interval_residuals(self, W: torch.Tensor) -> torch.Tensor:
        """[..., N, nc] all interval equality rows."""
        W = self.with_mask_lanes(W)
        return self.interval_residual(
            W[..., :-1, :], W[..., 1:, :], self.stage_mask, self.tie_mask,
            self.u_tie_mask,
        )

    def defects(self, traj: Trajectory) -> torch.Tensor:
        """[..., N, nx] dynamics defects only (diagnostics / tests)."""
        return self.interval_residuals(self.pack(traj))[..., : self.nx]

    @span("transcription.interval_jacobians")
    def interval_jacobians(self, W: torch.Tensor):
        """J [..., N, nc, nz], K [..., N, nc, nz], c [..., N, nc] — exact,
        forward-mode AD per interval vmapped over stages (and lanes)."""
        W = self.with_mask_lanes(W)
        m = self.stage_mask
        jac = torch.func.jacfwd(self.interval_residual, argnums=(0, 1))
        fn = torch.func.vmap(jac)  # over stages
        # a per-lane mask goes with the lanes; the tie masks are shared
        n_lane = 3 if self.per_lane_mask else 2
        if self.per_lane_mask:
            m = m.expand(W.shape[:-2] + m.shape[-1:])
        fn = _vmap_over_lead(fn, W.dim() - 2, n_lane, 5 - n_lane)
        J, K = fn(W[..., :-1, :], W[..., 1:, :], m, self.tie_mask, self.u_tie_mask)
        return J, K, self.interval_residuals(W)

    # ---------------- cost ----------------
    def _stage_term(self, w, w1, xref, xref1, uref, m, tie):
        """Cost contribution of one interval (uses w_k and, for the coupled
        integrations, stage k+1); all operands broadcast over leading dims.
        ``tie`` [...] is the interval's ``tie_mask`` entry (k < N−1): the
        linear-control Hermite-Simpson rule reads the next control there."""
        nx, nu = self.nx, self.nu
        x, u, dt = self.split_w(w, nx, nu)
        c = self.cost
        rule = self.grid.cost_integration
        if not c.integral:
            val = c.stage(x, u, dt, xref, uref)
        elif rule == "trapezoidal":
            x1 = w1[..., :nx]
            val = 0.5 * dt * (
                c.stage(x, u, dt, xref, uref)
                + c.stage(x1, u, dt, xref1, uref)
            )
        elif rule == "hermite_simpson_unc":
            # Simpson rule on the decision-variable midpoint
            x1 = w1[..., :nx]
            xm = w[..., nx + nu + 1:]
            xrefm = 0.5 * (xref + xref1)
            val = (dt / 6.0) * (
                c.stage(x, u, dt, xref, uref)
                + 4.0 * c.stage(xm, u, dt, xrefm, uref)
                + c.stage(x1, u, dt, xref1, uref)
            )
        elif rule in ("hermite_simpson", "hermite_simpson_lc"):
            # Simpson rule with the Hermite-interpolated midpoint; the _lc
            # rule interpolates the control linearly
            x1 = w1[..., :nx]
            u1 = u
            if rule == "hermite_simpson_lc":
                t1 = tie[..., None]
                u1 = t1 * w1[..., nx:nx + nu] + (1.0 - t1) * u
            um = 0.5 * (u + u1)
            xm = 0.5 * (x + x1)
            if self.system.continuous_time:
                xm = xm + (dt[..., None] / 8.0) * (self.system(x, u) - self.system(x1, u1))
            xrefm = 0.5 * (xref + xref1)
            val = (dt / 6.0) * (
                c.stage(x, u, dt, xref, uref)
                + 4.0 * c.stage(xm, um, dt, xrefm, uref)
                + c.stage(x1, u1, dt, xref1, uref)
            )
        else:  # left_sum (unknown rules were refused at construction)
            val = dt * c.stage(x, u, dt, xref, uref)
        return m * val

    @span("transcription.objective_from_W")
    def objective_from_W(self, W: torch.Tensor) -> torch.Tensor:
        xref, uref = self.refs.xref, self.refs.uref
        stage_sum = self._stage_term(
            W[..., :-1, :], W[..., 1:, :], xref[:-1], xref[1:], uref,
            self.stage_mask, self.tie_mask,
        ).sum(dim=-1)
        final = self.cost.final(W[..., -1, : self.nx], xref[-1])
        return stage_sum + final

    def objective(self, traj: Trajectory) -> torch.Tensor:
        return self.objective_from_W(self.pack(traj))

    @span("transcription.cost_gradient")
    def cost_gradient(self, W: torch.Tensor) -> torch.Tensor:
        """Exact gradient [..., N+1, nz] of every lane's objective (a per-lane
        mask gives W its lanes)."""
        W = self.with_mask_lanes(W)
        with torch.enable_grad():
            Wg = W.detach().requires_grad_(True)
            total = self.objective_from_W(Wg).sum()
            (grad,) = torch.autograd.grad(total, Wg, allow_unused=True)
        return torch.zeros_like(W) if grad is None else grad

    @span("transcription.cost_hessian_blocks")
    def cost_hessian_blocks(self, W: torch.Tensor) -> torch.Tensor:
        """Block-diagonal Hessian approximation Hd [..., N+1, nz, nz].

        Exact per-stage Hessian of φ_k(v) = all objective terms touching
        stage k, with neighboring stages frozen. Cross-stage cost coupling
        (trapezoidal and Hermite-Simpson integration) is dropped from the
        Hessian — but NOT from the gradient — which preserves exact KKT
        solutions."""
        N, nx = self.N, self.nx
        W = self.with_mask_lanes(W)
        dev, dtype = W.device, W.dtype
        xref, uref, mask = self.refs.xref, self.refs.uref, self.stage_mask
        ks = torch.arange(N + 1, device=dev)
        kl = ks.clamp(max=N - 1)  # interval k as left stage
        kr = (ks - 1).clamp(min=0)  # interval k-1 as right stage
        left = (ks < N).to(dtype)
        right = (ks > 0).to(dtype)
        is_term = (ks == N).to(dtype)
        couples = self.cost.integral and self.grid.cost_integration in _COUPLED_INTEGRATIONS
        xref_N = xref[-1]
        tie = self.tie_mask

        def phi(v, wp, wn, ml, mr, lf, rt, tm, xl, xl1, ul, xr, xr1, ur, tl, tr):
            total = lf * self._stage_term(v, wn, xl, xl1, ul, ml, tl)
            if couples:
                total = total + rt * self._stage_term(wp, v, xr, xr1, ur, mr, tr)
            return total + tm * self.cost.final(v[..., :nx], xref_N)

        pad = torch.zeros_like(W[..., :1, :])
        W_prev = torch.cat([pad, W[..., :-1, :]], dim=-2)
        W_next = torch.cat([W[..., 1:, :], pad], dim=-2)
        fn = torch.func.vmap(torch.func.hessian(phi, argnums=0))  # over stages
        # a per-lane mask goes with the lanes, the rest is shared
        n_lane = 5 if self.per_lane_mask else 3
        if self.per_lane_mask:
            mask = mask.expand(W.shape[:-2] + mask.shape[-1:])
        fn = _vmap_over_lead(fn, W.dim() - 2, n_lane, 16 - n_lane)
        return fn(
            W, W_prev, W_next, mask[..., kl], mask[..., kr], left, right, is_term,
            xref[kl], xref[kl + 1], uref[kl], xref[kr], xref[kr + 1], uref[kr],
            tie[kl], tie[kr],
        )

    # ---------------- general rows ----------------
    def _padded(self, parts, like):
        """Rows [..., ng]: ``parts`` concatenated, zero rows appended."""
        rows = torch.cat(parts, dim=-1) if parts else like[..., :0]
        pad = self.ng - rows.shape[-1]
        if pad:
            rows = torch.cat([rows, rows.new_zeros(rows.shape[:-1] + (pad,))], dim=-1)
        return rows

    def stage_rows(self, w, m, xref, uref):
        """Stage-constraint rows of stages w [..., nz] with stage-mask
        entries m [...] (equality rows first), padded to ng: [..., ng]."""
        x, u, dt = self.split_w(w, self.nx, self.nu)
        sc, parts = self.stage_con, []
        if sc is not None:
            if sc.neq:
                parts.append(m[..., None] * sc.eq(x, u, dt, xref, uref))
            if sc.nineq:
                parts.append(m[..., None] * sc.ineq(x, u, dt, xref, uref))
        return self._padded(parts, x)

    def terminal_rows(self, wN):
        """Terminal-constraint rows of stage N, wN [..., nz] → [..., ng]."""
        x = wN[..., : self.nx]
        tc, parts, xref = self.term_con, [], self.refs.xref[-1]
        if tc is not None:
            if tc.neq:
                parts.append(tc.eq(x, xref))
            if tc.nineq:
                parts.append(tc.ineq(x, xref))
        return self._padded(parts, x)

    def _row_bounds(self, con):
        neq, nineq = (0, 0) if con is None else (con.neq, con.nineq)
        inf = float("inf")
        pad = self.ng - neq - nineq
        return ([0.0] * neq + [-inf] * nineq + [-inf] * pad,
                [0.0] * neq + [0.0] * nineq + [inf] * pad)

    def general_row_bounds(self):
        """rl, ru [N+1, ng]: the same for every lane and every iterate."""
        ref = self.stage_mask
        (sl, su), (tl, tu) = self._row_bounds(self.stage_con), self._row_bounds(self.term_con)
        rows = lambda s, t_: torch.tensor(
            [s] * self.N + [t_], dtype=ref.dtype, device=ref.device).reshape(self.N + 1, self.ng)
        return rows(sl, tl), rows(su, tu)

    def general_rows(self, W: torch.Tensor):
        """Values r [..., N+1, ng] with bounds rl, ru [N+1, ng]: stage rows
        at k < N (masked by the stage mask), terminal rows at k = N."""
        if self.ng == 0:
            z = W.new_zeros(W.shape[:-1] + (0,))
            return z, z, z
        W = self.with_mask_lanes(W)
        refs = self.refs
        r_stage = self.stage_rows(W[..., :-1, :], self.stage_mask, refs.xref[:-1], refs.uref)
        r_term = self.terminal_rows(W[..., -1, :])
        rl, ru = self.general_row_bounds()
        return torch.cat([r_stage, r_term[..., None, :]], dim=-2), rl, ru

    def general_row_jacobians(self, W: torch.Tensor) -> torch.Tensor:
        """G [..., N+1, ng, nz], exact: the rows of stage k depend on w_k
        alone, so one forward-mode pass per column j of w (tangent e_j at
        every stage and lane) gives column j of every stage's block."""
        if self.ng == 0:
            return W.new_zeros(W.shape[:-1] + (0, self.nz))
        W = self.with_mask_lanes(W)
        rows = lambda V: self.general_rows(V)[0]
        cols = []
        for j in range(self.nz):
            tangent = torch.zeros_like(W)
            tangent[..., j] = 1.0
            cols.append(torch.func.jvp(rows, (W,), (tangent,))[1])
        return torch.stack(cols, dim=-1).to(W.dtype)

    # ---------------- structural invariants ----------------
    @property
    def lti_structure(self) -> bool:
        """True when the interval Jacobians J, K are constant in W: linear
        dynamics and dt pinned. Solvers hoist the linearization then."""
        return (
            bool(getattr(self.system, "is_linear", False))
            and not self.grid.dt_is_variable
        )

    @property
    def constant_hessian(self) -> bool:
        """True when the cost Hessian blocks are constant in W."""
        return self.lti_structure and bool(getattr(self.cost, "quadratic", False))

    # ---------------- bounds & pins ----------------
    def w_bounds(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Absolute box bounds lb, ub [N+1, nz] (before pinning)."""
        b = self.bounds
        lb_parts = [b.x_lb, b.u_lb, b.dt_lb[None]]
        ub_parts = [b.x_ub, b.u_ub, b.dt_ub[None]]
        if self.n_aux:
            # midpoint states carry the state bounds
            lb_parts.append(b.x_lb)
            ub_parts.append(b.x_ub)
        lb_row = torch.cat(lb_parts)
        ub_row = torch.cat(ub_parts)
        shape = (self.N + 1, self.nz)
        return lb_row.expand(shape), ub_row.expand(shape)

    def fixed_mask(self) -> torch.Tensor:
        """[N+1, nz] 1.0 where the variable is pinned to its current value:
        x_0, xf_fixed components of x_N, stage-N dummy u/dt, and all dt
        columns when the grid's dt is not a decision variable."""
        N, nx, nu, nz = self.N, self.nx, self.nu, self.nz
        ref = self.stage_mask
        m = torch.zeros((N + 1, nz), dtype=ref.dtype, device=ref.device)
        m[0, :nx] = 1.0
        m[N, nx:] = 1.0
        if self.bc.xf_fixed is not None:
            m[N, :nx] = self.bc.xf_fixed.to(m.dtype)
        if not self.grid.dt_is_variable:
            m[:, nx + nu] = 1.0
        return m

    def apply_boundary(self, traj: Trajectory) -> Trajectory:
        """Overwrite x_0 ← bc.x0 and pinned terminal components ← bc.xf.
        A batched bc.x0 [..., nx] batches X."""
        x0 = self.bc.x0.to(traj.X.dtype)
        lead = torch.broadcast_shapes(traj.X.shape[:-2], x0.shape[:-1])
        X = traj.X.expand(lead + traj.X.shape[-2:]).clone()
        X[..., 0, :] = x0
        if self.bc.xf_fixed is not None and self.bc.xf is not None:
            mask = self.bc.xf_fixed.to(X.dtype)
            X[..., -1, :] = mask * self.bc.xf + (1.0 - mask) * X[..., -1, :]
        return traj.replace(X=X)

    def replace(self, **changes) -> "TranscribedOCP":
        """Copy with ``changes``; a new grid gets its own ``u_tie_mask``."""
        if changes.get("grid", self.grid) is not self.grid:
            changes.setdefault("u_tie_mask", None)
        return dataclasses.replace(self, **changes)

    def to(self, device=None, dtype=None) -> "TranscribedOCP":
        """Copy with every tensor on ``device`` (floating ones as ``dtype``)."""
        return tree_to(self, device, dtype)


def transcribe(
    system: SystemDynamics,
    grid: Grid,
    cost: StageCost,
    bounds: Optional[Bounds] = None,
    x0: Optional[torch.Tensor] = None,
    xf: Optional[torch.Tensor] = None,
    xf_fixed: Optional[torch.Tensor] = None,
    refs: Optional[References] = None,
    stage_con=None,
    term_con=None,
    stage_mask: Optional[torch.Tensor] = None,
    dtype=None,
    device=None,
) -> TranscribedOCP:
    """Convenience constructor with sensible defaults. Every tensor of the
    result is cast to ``dtype`` (``None`` means float32) and moved to
    ``device`` (``None`` means the card, and raises when there is none)."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    nx, nu, N = system.nx, system.nu, grid.N
    if bounds is None:
        bounds = Bounds.unbounded(nx, nu, dtype, device)
    if x0 is None:
        x0 = torch.zeros((nx,))
    if refs is None:
        xr = xf if xf is not None else torch.zeros((nx,))
        refs = References.constant(torch.as_tensor(xr), torch.zeros((nu,)), N)
    if stage_mask is None:
        stage_mask = torch.ones((N,))
    bc = BoundaryConditions(
        x0=torch.as_tensor(x0),
        xf=None if xf is None else torch.as_tensor(xf),
        xf_fixed=None if xf_fixed is None else torch.as_tensor(xf_fixed),
    )
    ocp = TranscribedOCP(
        grid=grid, system=system, cost=cost, stage_con=stage_con,
        term_con=term_con, bounds=bounds, bc=bc, refs=refs,
        stage_mask=torch.as_tensor(stage_mask),
    )
    return ocp.to(device=device, dtype=dtype)
