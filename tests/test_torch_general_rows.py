"""PyTorch port vs JAX package: general rows (ng > 0) through the
transcription, the stage QP, SQP and LM, and the PSD clamp.

Same numpy inputs from a seed through both, float64:
  - ``general_rows`` / ``general_row_jacobians`` (stage rows of a functional
    constraint with equality and inequality rows, masked per lane; terminal
    rows of a terminal ball, padded) against the JAX functions lane by lane
    with each lane's mask: values, bounds and G to 1e-12;
  - ``solve_stage_qp`` with general rows (equality and inequality rows) by
    the non-fused ADMM against the JAX non-fused ADMM over the same rounds
    (δ and every dual 1e-9), and on a QP whose only general rows are
    equalities and whose box rows are inactive against ``dense_qp_oracle``
    (1e-6); ``backend='fused'`` with general rows raises by name;
  - SQP on the constrained double integrator (x₂ ≥ −0.9, x_N = 0) against
    ``jax.jit(jax.vmap(sqp_solve))`` on three lanes: W 1e-8, y_gen 1e-6,
    iterations equal; LM on it, one JAX lane per call (ROADMAP queue 3):
    W 1e-8, iterations equal;
  - the PSD clamp: SQP under ``MinTimeQuadraticGainScheduled`` (a cost with
    indefinite Hessian blocks at the initial guess) and under
    ``psd_clamp=True`` on config 1 (the hoisted path) against JAX, W 1e-8;
  - the refusals of the other-grids slice (bcr, move blocking, the other FD
    schemes, the other cost integrations) still raise by name.
The JAX side runs under ``jax.jit``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.models import DoubleIntegratorContinuous as JDI
from control_box_rst_tpu.ocp import (
    Bounds,
    CompositeCost,
    QuadraticFinalStateCost,
    QuadraticFormCost,
    finite_differences_grid,
    transcribe,
)
from control_box_rst_tpu.ocp import costs as jc
from control_box_rst_tpu.ocp.constraints import (
    FunctionalStageConstraint,
    TerminalBall,
    terminal_equality,
)
from control_box_rst_tpu.ocp.problem import Trajectory as JT
from control_box_rst_tpu.solvers import LMConfig as JLM
from control_box_rst_tpu.solvers import QPConfig as JQP
from control_box_rst_tpu.solvers import SQPConfig as JSQP
from control_box_rst_tpu.solvers import StageQP as JStageQP
from control_box_rst_tpu.solvers import lm_solve as jlm
from control_box_rst_tpu.solvers import solve_stage_qp as jsolve_qp
from control_box_rst_tpu.solvers import sqp_solve as jsqp
from control_box_rst_tpu_torch import convert, entry
from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.solvers import (
    LMConfig,
    QPConfig,
    SQPConfig,
    dense_qp_oracle,
    lm_solve,
    solve_stage_qp,
    sqp_solve,
)

from torch_port_util import ocp_spec, random_qp_batch_np, to_np

torch.set_num_threads(1)
F64 = torch.float64


def _jax_rows_ocp(N=6):
    sc = FunctionalStageConstraint(
        neq=1, nineq=2, eq_fn=lambda x, u: x[0] + 0.5 * u[0] ** 2 - 0.2,
        ineq_fn=lambda x, u: jnp.stack([-x[1] - 0.9, x[0] * x[1] - 1.0]))
    return transcribe(
        JDI(), finite_differences_grid(N), QuadraticFormCost(Q=jnp.eye(2), R=0.1 * jnp.eye(1)),
        bounds=Bounds.unbounded(2, 1).with_u(-1.0, 1.0), x0=jnp.array([1.0, 0.0]),
        stage_con=sc, term_con=TerminalBall(S=jnp.diag(jnp.array([2.0, 0.5])), gamma=0.3))


def _torch_rows_spec(ocp):
    return ocp_spec(
        ocp,
        stage_con=dict(kind="FunctionalStageConstraint", neq=1, nineq=2,
                       eq_fn=lambda x, u: x[..., :1] + 0.5 * u[..., :1] ** 2 - 0.2,
                       ineq_fn=lambda x, u: torch.cat(
                           [-x[..., 1:2] - 0.9, x[..., :1] * x[..., 1:2] - 1.0], dim=-1)),
        term_con=dict(kind="TerminalBall", S=np.diag([2.0, 0.5]), gamma=0.3))


def _di_constrained_jax(N=25):
    sc = FunctionalStageConstraint(nineq=1, ineq_fn=lambda x, u: -x[1] - 0.9)
    return transcribe(
        JDI(), finite_differences_grid(N), QuadraticFormCost(Q=jnp.eye(2), R=0.1 * jnp.eye(1)),
        bounds=Bounds.unbounded(2, 1).with_u(-1.0, 1.0), x0=jnp.array([2.0, 0.0]),
        stage_con=sc, term_con=terminal_equality(2))


DI_X0S = np.array([[2.0, 0.0], [-1.4, 0.0], [0.7, 0.0]])


def test_general_rows_and_jacobians_with_a_per_lane_mask():
    N, B = 6, 4
    jocp = _jax_rows_ocp(N)
    rng = np.random.default_rng(7)
    W = rng.standard_normal((B, N + 1, 4))
    masks = np.ones((B, N))
    masks[1, 4:] = 0.0
    masks[2, 2:] = 0.0
    masks[3, 5:] = 0.0

    def one(Wb, m):
        o = jocp.replace(stage_mask=m)
        r, rl, ru = o.general_rows(Wb)
        return r, rl, ru, o.general_row_jacobians(Wb)

    r_j, rl_j, ru_j, G_j = (np.asarray(a) for a in jax.jit(jax.vmap(one))(W, masks))
    tocp = convert.ocp_from_numpy(_torch_rows_spec(jocp), dtype=F64, device="cpu")
    tocp = tocp.replace(stage_mask=torch.from_numpy(masks))
    assert (tocp.ng, tocp.ng_stage, tocp.ng_term) == (jocp.ng, jocp.ng_stage, jocp.ng_term) == (3, 3, 1)
    r, rl, ru = tocp.general_rows(torch.from_numpy(W))
    G = tocp.general_row_jacobians(torch.from_numpy(W))
    np.testing.assert_allclose(to_np(r), r_j, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(to_np(rl), rl_j[0])
    np.testing.assert_array_equal(to_np(ru), ru_j[0])
    np.testing.assert_allclose(to_np(G), G_j, rtol=0, atol=1e-12)
    # masked stages carry zero rows; the terminal rows are never masked
    assert not to_np(r)[2, 2:N].any() and to_np(r)[2, N, 0] != 0.0


def _qp_with_general_rows(seed, ng=3, B=3):
    d = random_qp_batch_np(range(seed, seed + B))
    rng = np.random.default_rng(seed + 50)
    Kst, nz = d["g"].shape[1:]
    d["G"] = 0.5 * rng.standard_normal((B, Kst, ng, nz))
    gl = np.full((B, Kst, ng), -1e8)
    gu = 0.2 + 0.1 * rng.random((B, Kst, ng))
    gl[:, :, 0] = gu[:, :, 0] = 0.05 * rng.standard_normal((B, Kst))  # an equality row
    d["gl"], d["gu"] = gl, gu
    return d


def test_stage_qp_with_general_rows_equals_the_jax_admm():
    d = _qp_with_general_rows(11)
    jcfg = JQP(max_iter=300, iters_per_round=25, tol=1e-30, backend="xla")
    want = jax.jit(jax.vmap(lambda q: jsolve_qp(q, jcfg)))(
        JStageQP(**{k: jnp.asarray(v) for k, v in d.items()}))
    got = solve_stage_qp(convert.stage_qp_from_numpy(d, dtype=F64, device="cpu"),
                         QPConfig(max_iter=300, iters_per_round=25, tol=1e-30, backend="plain"))
    for name in ("delta", "y_dyn", "y_gen", "y_box"):
        np.testing.assert_allclose(to_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(to_np(got.iters), np.asarray(want.iters))
    # the default budget with general rows: 600 iterations, as the reference's
    got_d = solve_stage_qp(convert.stage_qp_from_numpy(d, dtype=F64, device="cpu"),
                           QPConfig(tol=1e-30, backend="plain"))
    assert int(got_d.iters.max()) == 600


def test_stage_qp_with_equality_general_rows_meets_the_dense_oracle():
    d = _qp_with_general_rows(21, ng=2, B=1)
    d = {k: v[0] for k, v in d.items()}
    d["gl"][:, 1], d["gu"][:, 1] = -1e8, 1e8  # row 1 never binds
    d["dlb"] = np.where(d["dlb"] == d["dub"], 0.0, -1e3)
    d["dub"] = np.where(d["dlb"] == 0.0, 0.0, 1e3)
    qp = convert.stage_qp_from_numpy(d, dtype=F64, device="cpu")
    x_star, y_star = dense_qp_oracle(qp)
    sol = solve_stage_qp(qp, QPConfig(max_iter=20000, iters_per_round=100, tol=1e-11,
                                      backend="plain"))
    np.testing.assert_allclose(to_np(sol.delta), to_np(x_star), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(sol.y_dyn), to_np(y_star), rtol=0, atol=1e-6)


def test_fused_backend_with_general_rows_raises_by_name():
    d = _qp_with_general_rows(31)
    qp = convert.stage_qp_from_numpy(d, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="general rows"):
        solve_stage_qp(qp, QPConfig(backend="fused"))


def _jax_di_solves(solver, x0s, N=25):
    ocp = _di_constrained_jax(N)

    def one(x0):
        o = ocp.replace(bc=ocp.bc.replace(x0=x0))
        return solver(o, JT.linear_interp(x0, jnp.zeros(2), N, 1, 0.25))

    return jax.jit(jax.vmap(one))


def _port_di(x0s):
    ocp, sqp_cfg, lm_cfg, ip_cfg = entry.constrained_di(dtype=F64, device="cpu")
    x0 = torch.as_tensor(x0s, dtype=F64)
    o = ocp.replace(bc=ocp.bc.replace(x0=x0))
    return o, Trajectory.linear_interp(x0, torch.zeros(2, dtype=F64), ocp.N, 1, 0.25), sqp_cfg


def test_sqp_on_the_constrained_double_integrator_equals_the_reference():
    want = _jax_di_solves(lambda o, t: jsqp(o, t, JSQP(max_iter=30)), DI_X0S)(jnp.asarray(DI_X0S))
    o, t0, cfg = _port_di(DI_X0S)
    assert cfg.max_iter == 30 and cfg.qp.backend is None
    got = sqp_solve(o, t0, cfg)
    np.testing.assert_allclose(to_np(got.W), np.asarray(want.W), rtol=0, atol=1e-8)
    np.testing.assert_allclose(to_np(got.y_gen), np.asarray(want.y_gen), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to_np(got.iterations), np.asarray(want.iterations))
    np.testing.assert_array_equal(to_np(got.status), np.asarray(want.status))
    X = to_np(got.traj.X)
    assert X[..., 1].min() >= -0.9 - 1e-7 and np.abs(X[:, -1]).max() < 1e-7


@pytest.mark.parametrize("lane", [0, 1])
def test_lm_on_the_constrained_double_integrator_equals_the_reference(lane):
    x0s = DI_X0S[lane:lane + 1]
    want = _jax_di_solves(lambda o, t: jlm(o, t, JLM(max_iter=60)), x0s)(jnp.asarray(x0s))
    o, t0, _ = _port_di(x0s)
    got = lm_solve(o, t0, LMConfig(max_iter=60))
    np.testing.assert_allclose(to_np(got.W), np.asarray(want.W), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(to_np(got.iterations), np.asarray(want.iterations))
    np.testing.assert_array_equal(to_np(got.status), np.asarray(want.status))
    np.testing.assert_allclose(to_np(got.chi2), np.asarray(want.chi2), rtol=1e-8, atol=0)


def _gain_scheduled_jax(N=10):
    cost = CompositeCost(costs=(
        jc.MinTimeQuadraticGainScheduled(time_weight=1.0, Q=jnp.eye(2), R=0.1 * jnp.eye(1),
                                         radius=0.6, sharpness=8.0),
        QuadraticFinalStateCost(Qf=5.0 * jnp.eye(2)),
    ))
    return transcribe(
        JDI(), finite_differences_grid(N), cost,
        bounds=Bounds.unbounded(2, 1).with_u(-1.0, 1.0).with_dt(0.1, 0.1), x0=jnp.array([0.5, 0.0]))


def test_psd_clamp_under_the_gain_scheduled_cost():
    N = 10
    jocp = _gain_scheduled_jax(N)
    x0s = np.array([[0.5, 0.0], [0.3, -0.4]])

    def one(x0):
        o = jocp.replace(bc=jocp.bc.replace(x0=x0))
        return jsqp(o, JT.linear_interp(x0, jnp.zeros(2), N, 1, 0.1), JSQP(max_iter=20))

    want = jax.jit(jax.vmap(one))(jnp.asarray(x0s))
    tocp = convert.ocp_from_numpy(ocp_spec(jocp), dtype=F64, device="cpu")
    assert not tocp.cost.convex
    x0 = torch.as_tensor(x0s)
    t0 = Trajectory.linear_interp(x0, torch.zeros(2, dtype=F64), N, 1, 0.1)
    o = tocp.replace(bc=tocp.bc.replace(x0=x0))
    # the clamp has work to do: an indefinite Hessian block at the initial guess
    H = tocp.cost_hessian_blocks(o.pack(o.apply_boundary(t0)))
    assert float(torch.linalg.eigvalsh(H).min()) < -1e-3
    got = sqp_solve(o, t0, SQPConfig(max_iter=20))
    np.testing.assert_allclose(to_np(got.W), np.asarray(want.W), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(to_np(got.iterations), np.asarray(want.iterations))


def test_psd_clamp_on_the_hoisted_path_of_config_1():
    from torch_port_util import jax_flagship, torch_ocp_like

    N = 12
    jocp, _ = jax_flagship(N, jnp.float64)
    x0s = np.array([[0.8, -0.3], [-0.5, 0.6]])
    jcfg = JSQP(max_iter=10, psd_clamp=True, qp=JQP(backend="xla"))

    def one(x0):
        o = jocp.replace(bc=jocp.bc.replace(x0=x0))
        return jsqp(o, JT.linear_interp(x0, jnp.zeros(2), N, 1, 0.1), jcfg)

    want = jax.jit(jax.vmap(one))(jnp.asarray(x0s))
    tocp = torch_ocp_like(jocp, "float64")
    x0 = torch.as_tensor(x0s)
    got = sqp_solve(tocp.replace(bc=tocp.bc.replace(x0=x0)),
                    Trajectory.linear_interp(x0, torch.zeros(2, dtype=F64), N, 1, 0.1),
                    SQPConfig(max_iter=10, psd_clamp=True, qp=QPConfig(backend="plain")))
    np.testing.assert_allclose(to_np(got.W), np.asarray(want.W), rtol=0, atol=1e-8)


@pytest.mark.parametrize("case", ["bcr", "move_blocking", "hermite_simpson", "backward",
                                  "cost_integration"])
def test_other_grid_slice_refusals_still_raise_by_name(case):
    """What the other-grids slice brought no longer raises: 'bcr' solves the
    general-row QP as 'scan' does (1e-10), the move-blocking, Hermite-Simpson
    and backward grids transcribe; an unknown cost integration still raises
    by name."""
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.ocp import Grid, QuadraticFormCost as TQF, transcribe as ttr

    cost = TQF(Q=torch.eye(2, dtype=F64), R=torch.eye(1, dtype=F64))
    if case == "bcr":
        qp = convert.stage_qp_from_numpy(_qp_with_general_rows(41), dtype=F64, device="cpu")
        sols = [solve_stage_qp(qp, QPConfig(linsolver=ls, backend="plain"))
                for ls in ("bcr", "scan")]
        np.testing.assert_allclose(to_np(sols[0].delta), to_np(sols[1].delta), rtol=0, atol=1e-10)
        assert torch.equal(sols[0].iters, sols[1].iters)
        return
    grid = {"move_blocking": Grid(N=4, u_blocks=(2, 2, 2, 2)),
            "hermite_simpson": Grid(N=4, fd_scheme="hermite_simpson"),
            "backward": Grid(N=4, fd_scheme="backward"),
            "cost_integration": Grid(N=4, cost_integration="simpson")}[case]
    if case == "cost_integration":
        with pytest.raises(KeyError, match="cost integration"):
            ttr(DoubleIntegratorContinuous(), grid, cost.replace(integral=True),
                dtype=F64, device="cpu")
        return
    ocp = ttr(DoubleIntegratorContinuous(), grid, cost, dtype=F64, device="cpu")
    assert (ocp.nz, ocp.nc) == (4, 3 if case == "move_blocking" else 2)
