"""PyTorch port vs JAX package: the other grids — every FD scheme, every
cost integration, the uncompressed Hermite-Simpson grid (midpoint slots in
the stage vector) and move blocking (u tie rows).

- Collocation: every defect, quadrature and the uncompressed rows of
  ``ops/collocation.py`` on seeded batches of points against the JAX
  functions under ``jax.vmap`` (float64, 1e-12).
- Transcription (float64, 1e-10): residuals, interval Jacobians, objective,
  gradient, Hessian blocks, bounds, pins and packing of six OCPs — Van der
  Pol on the backward, midpoint, Hermite-Simpson, linear-control
  Hermite-Simpson and uncompressed Hermite-Simpson schemes with the
  trapezoidal, left-sum and three Simpson cost integrations, and the double
  integrator on a move-blocking grid — each with one stage mask for every
  lane and with a per-lane stage mask [B, N] (against ``jax.vmap`` over
  lanes). Shapes and slots: nz, nc, n_aux, n_tie.
- SQP solves (float64, the non-fused ADMM on both sides, 1e-6): Van der
  Pol on the Hermite-Simpson and uncompressed grids, the double integrator
  with move blocking; the blocked controls equal inside each block; the
  reference's uncompressed solution, midpoint slots included, handed over
  by ``convert.stage_matrix_from_numpy`` bit for bit.

Every JAX call goes through ``jax.jit`` (see tests/test_torch_ops.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
from control_box_rst_tpu.models import VanDerPolOscillator as JaxVdP
from control_box_rst_tpu.ocp import (
    Bounds as JBounds,
    CompositeCost as JComposite,
    QuadraticFinalStateCost as JQf,
    QuadraticFormCost as JQF,
    References as JRefs,
    Trajectory as JTraj,
    finite_differences_grid as j_fd_grid,
    hermite_simpson_uncompressed_grid as j_hs_unc_grid,
    move_blocking_grid as j_mb_grid,
    transcribe as j_transcribe,
)
from control_box_rst_tpu.ops import collocation as jcol
from control_box_rst_tpu.solvers import QPConfig as JQPConfig
from control_box_rst_tpu.solvers import SQPConfig as JSQPConfig
from control_box_rst_tpu.solvers import sqp_solve as j_sqp_solve
from control_box_rst_tpu_torch import convert
from control_box_rst_tpu_torch.models import VanDerPolOscillator as TVdP
from control_box_rst_tpu_torch.ocp import Trajectory as TTraj
from control_box_rst_tpu_torch.ocp import move_blocking_grid as t_mb_grid
from control_box_rst_tpu_torch.ocp import stage_mask_from_n
from control_box_rst_tpu_torch.ops import collocation as tcol
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig, sqp_solve

from torch_port_util import spec_from_jax_ocp, to_np

torch.set_num_threads(1)
TOL = 1e-10
COL_TOL = 1e-12
SOLVE_TOL = 1e-6
N = 6
F64 = dict(dtype=torch.float64, device="cpu")

# variant -> (system, fd_scheme or grid, cost_integration)
VARIANTS = {
    "backward_trapezoidal": ("vdp", "backward", "trapezoidal"),
    "midpoint_left_sum": ("vdp", "midpoint", "left_sum"),
    "hermite_simpson": ("vdp", "hermite_simpson", "hermite_simpson"),
    "hermite_simpson_lc": ("vdp", "hermite_simpson_lc", "hermite_simpson_lc"),
    "hermite_simpson_unc": ("vdp", "hermite_simpson_unc", "hermite_simpson_unc"),
    "move_blocking": ("di", "crank_nicolson", "trapezoidal"),
}


# --------------------------------------------------------------------------
# collocation
# --------------------------------------------------------------------------

def _points(seed, n=7):
    rng = np.random.default_rng(seed)
    x1, x2, xm = (rng.standard_normal((n, 2)) for _ in range(3))
    u1, u2 = (rng.standard_normal((n, 1)) for _ in range(2))
    dt = rng.uniform(0.05, 0.3, n)
    return x1, u1, x2, u2, xm, dt


def _stage_cost(x, u):
    return (x ** 2).sum(-1) + 0.3 * (x[..., :1] * u).sum(-1) + 0.1 * (u ** 2).sum(-1)


@pytest.mark.parametrize("name", [
    "backward_diff_defect", "midpoint_diff_defect", "forward_diff_defect",
    "crank_nicolson_defect", "hermite_simpson_defect", "hermite_simpson_lc_defect",
    "hermite_simpson_unc_rows", "quadrature_left_sum", "quadrature_trapezoidal",
    "quadrature_hermite_simpson", "quadrature_hermite_simpson_lc",
])
def test_collocation_matches_jax(name):
    x1, u1, x2, u2, xm, dt = _points(3)
    fj, ft = JaxVdP(), TVdP()
    jf, tf = getattr(jcol, name), getattr(tcol, name)
    if name.startswith("quadrature"):
        lc = name.endswith("_lc")
        ops = (x1, u1, x2, u2, dt) if lc else (x1, u1, x2, dt)
        kw_j = dict(f=fj) if "simpson" in name else {}
        kw_t = dict(f=ft) if "simpson" in name else {}
        want = jax.jit(jax.vmap(lambda *a: jf(_stage_cost, *a, **kw_j)))(*map(jnp.asarray, ops))
        got = tf(_stage_cost, *map(torch.as_tensor, ops), **kw_t)
        if "simpson" in name:  # without the dynamics: the arithmetic midpoint
            want0 = jax.jit(jax.vmap(lambda *a: jf(_stage_cost, *a)))(*map(jnp.asarray, ops))
            np.testing.assert_allclose(to_np(tf(_stage_cost, *map(torch.as_tensor, ops))),
                                       np.asarray(want0), rtol=0, atol=COL_TOL)
    else:
        ops = {"hermite_simpson_lc_defect": (x1, u1, x2, u2, dt),
               "hermite_simpson_unc_rows": (x1, xm, u1, x2, dt)}.get(name, (x1, u1, x2, dt))
        want = jax.jit(jax.vmap(lambda *a: jf(fj, *a)))(*map(jnp.asarray, ops))
        got = tf(ft, *map(torch.as_tensor, ops))
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=COL_TOL)


# --------------------------------------------------------------------------
# transcription
# --------------------------------------------------------------------------

def _jax_ocp(variant, x0=(0.8, -0.3)):
    system, scheme, rule = VARIANTS[variant]
    sys_j = JaxVdP() if system == "vdp" else JaxDI()
    if variant == "hermite_simpson_unc":
        grid = j_hs_unc_grid(N)
    elif variant == "move_blocking":
        grid = j_mb_grid(N, [2, 3, 1], fd_scheme=scheme, cost_integration=rule)
    else:
        grid = j_fd_grid(N, fd_scheme=scheme, cost_integration=rule)
    cost = JComposite(costs=(JQF(Q=jnp.eye(2), R=0.1 * jnp.eye(1), integral=True),
                             JQf(Qf=5.0 * jnp.eye(2))), integral=True)
    rng = np.random.default_rng(11)
    refs = JRefs(xref=jnp.asarray(0.3 * rng.standard_normal((N + 1, 2))),
                 uref=jnp.asarray(0.2 * rng.standard_normal((N, 1))))
    bounds = JBounds.unbounded(2, 1).with_u(-2.0, 2.0).with_x(
        jnp.array([-0.8, -jnp.inf]), jnp.array([2.0, jnp.inf])).with_dt(0.1, 0.1)
    return j_transcribe(sys_j, grid, cost, bounds=bounds, x0=jnp.asarray(x0), refs=refs)


def _torch_ocp(ocp_j):
    spec = spec_from_jax_ocp(ocp_j)
    spec["u_blocks"] = ocp_j.grid.u_blocks
    return convert.ocp_from_numpy(spec, **F64)


def _random_W(seed, lead, nz):
    """Stage matrices from a seed, dts in [0.05, 0.3], stage N's dummy
    control and dt 0 (its midpoint slots random)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal(tuple(lead) + (N + 1, nz)) * 0.6
    W[..., :, 3] = rng.uniform(0.05, 0.3, tuple(lead) + (N + 1,))
    W[..., -1, 2:4] = 0.0
    return W


def _evaluations(ocp, W):
    J, K, c = ocp.interval_jacobians(W)
    return dict(res=ocp.interval_residuals(W), J=J, K=K, c=c, obj=ocp.objective_from_W(W),
                grad=ocp.cost_gradient(W), H=ocp.cost_hessian_blocks(W))


def _jax_evaluations(ocp_j, W):
    J, K, c = ocp_j.interval_jacobians(W)
    return dict(res=ocp_j.interval_residuals(W), J=J, K=K, c=c, obj=ocp_j.objective_from_W(W),
                grad=ocp_j.cost_gradient(W), H=ocp_j.cost_hessian_blocks(W))


@pytest.mark.parametrize("mask", ["one_mask", "per_lane_mask"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_transcription_matches_jax(variant, mask):
    ocp_j = _jax_ocp(variant)
    ocp_t = _torch_ocp(ocp_j)
    assert (ocp_t.nz, ocp_t.nc, ocp_t.n_aux, ocp_t.n_tie) == (
        ocp_j.nz, ocp_j.nc, ocp_j.n_aux, ocp_j.n_tie)
    for a, b in zip(ocp_t.w_bounds(), jax.jit(ocp_j.w_bounds)()):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    np.testing.assert_array_equal(to_np(ocp_t.fixed_mask()), np.asarray(ocp_j.fixed_mask()))
    # packing: the midpoint slots start at the linear midpoints
    x0, xf = np.array([0.8, -0.3]), np.array([0.1, 0.2])
    tj = jax.jit(lambda a, b: JTraj.linear_interp(a, b, N, 1, 0.1))(jnp.asarray(x0), jnp.asarray(xf))
    tj = tj.replace(U=jnp.linspace(-1.0, 1.0, N)[:, None])
    tt = TTraj(**{k: torch.as_tensor(np.array(getattr(tj, k))) for k in ("X", "U", "dts")})
    np.testing.assert_allclose(to_np(ocp_t.pack(tt)), np.asarray(jax.jit(ocp_j.pack)(tj)),
                               rtol=0, atol=TOL)
    if mask == "one_mask":
        m = np.ones(N)
        m[-2:] = 0.0  # a masked tail: the identity chain (midpoint pinned to x)
        ocp_j = ocp_j.replace(stage_mask=jnp.asarray(m))
        ocp_t = ocp_t.replace(stage_mask=torch.as_tensor(m))
        W = _random_W(0, (), ocp_t.nz)
        got = _evaluations(ocp_t, torch.as_tensor(W))
        want = jax.jit(lambda w: _jax_evaluations(ocp_j, w))(jnp.asarray(W))
    else:
        n_active = np.array([6, 4, 1])
        ocp_m = ocp_t.replace(stage_mask=stage_mask_from_n(
            torch.as_tensor(n_active), N, torch.float64))
        W = _random_W(1, (len(n_active),), ocp_t.nz)
        got = _evaluations(ocp_m, torch.as_tensor(W))
        want = jax.jit(jax.vmap(lambda m, w: _jax_evaluations(ocp_j.replace(stage_mask=m), w)))(
            jnp.asarray(to_np(ocp_m.stage_mask)), jnp.asarray(W))
    for key in want:
        np.testing.assert_allclose(to_np(got[key]), np.asarray(want[key]), rtol=0, atol=TOL,
                                   err_msg=key)
    if variant == "move_blocking":
        # tie rows u_{k+1} − u_k inside the blocks [2, 3, 1], zero elsewhere
        tie = to_np(got["res"])[..., -1]
        U = W[..., :-1, 2]
        want_tie = (U[..., 1:] - U[..., :-1]) * np.array([1, 0, 1, 1, 0])
        np.testing.assert_allclose(tie[..., :-1], want_tie, rtol=0, atol=TOL)
        assert np.all(tie[..., -1] == 0.0)
        # the [N, nu] mask follows the grid through replace
        mb = ocp_t.u_tie_mask
        np.testing.assert_array_equal(to_np(mb)[:, 0], [1, 0, 1, 1, 0, 0])
        plain = ocp_t.replace(grid=ocp_t.grid.replace(u_blocks=None))
        assert plain.u_tie_mask.shape == (N, 1) and not plain.u_tie_mask.any()
        assert plain.replace(grid=ocp_t.grid).u_tie_mask.equal(mb)
        assert ocp_t.replace(stage_mask=ocp_t.stage_mask).u_tie_mask is mb


# --------------------------------------------------------------------------
# SQP solves
# --------------------------------------------------------------------------

SOLVES = {
    "hermite_simpson": ("vdp", j_fd_grid(8, fd_scheme="hermite_simpson",
                                         cost_integration="hermite_simpson")),
    "hermite_simpson_unc": ("vdp", j_hs_unc_grid(8)),
    "move_blocking": ("di", j_mb_grid(12, [4, 4, 4], fd_scheme="crank_nicolson")),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_sqp_solve_matches_jax(case):
    system, grid = SOLVES[case]
    n = grid.N
    sys_j = JaxVdP() if system == "vdp" else JaxDI()
    integral = system == "vdp"
    cost = JComposite(costs=(JQF(Q=jnp.eye(2), R=0.1 * jnp.eye(1), integral=integral),
                             JQf(Qf=(5.0 if integral else 10.0) * jnp.eye(2))),
                      integral=integral)
    x0 = jnp.array([1.0, 0.5] if integral else [1.0, 0.0])
    bounds = JBounds.unbounded(2, 1).with_u(-2.0, 2.0).with_dt(0.1, 0.1)
    ocp_j = j_transcribe(sys_j, grid, cost, bounds=bounds, x0=x0)
    traj_j = JTraj.linear_interp(x0, jnp.zeros(2), n, 1, 0.1)
    cfg_j = JSQPConfig(max_iter=20, qp=JQPConfig(max_iter=400, tol=1e-10),
                       tol_stat=1e-7, tol_feas=1e-9)
    res_j = jax.jit(lambda t: j_sqp_solve(ocp_j, t, cfg_j))(traj_j)
    ocp_t = _torch_ocp(ocp_j)
    traj_t = TTraj(**{k: torch.as_tensor(np.array(getattr(traj_j, k))) for k in ("X", "U", "dts")})
    cfg_t = SQPConfig(max_iter=20, qp=QPConfig(max_iter=400, tol=1e-10, backend="plain"),
                      tol_stat=1e-7, tol_feas=1e-9)
    res_t = sqp_solve(ocp_t, traj_t, cfg_t)
    assert int(res_t.status) == int(res_j.status) == 1
    assert abs(int(res_t.iterations) - int(res_j.iterations)) <= 1
    for key in ("W", "y_dyn"):
        np.testing.assert_allclose(to_np(getattr(res_t, key)), np.asarray(getattr(res_j, key)),
                                   rtol=0, atol=SOLVE_TOL, err_msg=key)
    if case == "hermite_simpson_unc":
        # the reference's solution with its midpoint slots, handed over
        W_j = np.asarray(res_j.W)
        W_h = convert.stage_matrix_from_numpy(ocp_t, dict(
            X=W_j[:, :2], U=W_j[:-1, 2:3], dts=W_j[:-1, 3], Xm=W_j[:, 4:]), **F64)
        np.testing.assert_array_equal(to_np(W_h), W_j)
        c_h = to_np(ocp_t.interval_residuals(W_h))
        assert np.abs(c_h).max() < 1e-8  # a feasible point: the midpoint ties hold
    if case == "move_blocking":
        U = to_np(res_t.traj.U)[:, 0]
        for b in range(3):
            np.testing.assert_allclose(U[4 * b:4 * (b + 1)], U[4 * b], rtol=0, atol=1e-7)
        assert abs(U[0] - U[4]) > 1e-3
        assert t_mb_grid(12, [4, 4, 4]).u_blocks == grid.u_blocks
