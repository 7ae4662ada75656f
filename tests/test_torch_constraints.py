"""PyTorch port vs JAX package: constraint objects, the costs of the
constrained slice, the stage preprocessor and the generic NLP interface.

Same numpy inputs from a seed through both, float64:
  - every constraint class (functional stage rows, terminal ball, terminal
    ball from a cost, terminal equality, terminal partial equality) and
    every new cost (quadratic state / control, regularized minimum time,
    the min-time quadratic blends, the gain-scheduled blend, the L1 soft
    constraint) against the JAX stage function evaluated point by point,
    1e-12; the LSQ residuals of the quadratic state / control costs 1e-12;
    ``CompositeCost`` derives ``convex`` as the reference does;
  - ``convert.cost_from_numpy`` / ``constraint_from_numpy`` rebuild the
    JAX objects from their numpy specs (the same values, 1e-12);
  - the preprocessor tests of tests/test_preprocessor_and_threaded_plant.py
    (lines 31-75): a shared quantity in a cost and a constraint, and a
    velocity bound through the preprocessor enforced by SQP, against the
    JAX SQP solve (X 1e-8);
  - ``solve_nlp`` on the problems of tests/test_simple_nlp.py against the
    JAX solve (1e-8) and the analytic optimum (the reference test's
    tolerances);
  - ``riccati_terminal_cost`` (ported with the LQR family) gives the
    double integrator's CARE solution.
The JAX side runs under ``jax.jit``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.ocp import constraints as jcon
from control_box_rst_tpu.ocp import costs as jc
from control_box_rst_tpu_torch import convert
from control_box_rst_tpu_torch.ocp import constraints as tcon
from control_box_rst_tpu_torch.ocp import costs as tc

from torch_port_util import obj_spec, to_np

torch.set_num_threads(1)
TOL = 1e-12
NX, NU, LEAD = 3, 2, (4, 5)


def _psd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T


def _points(seed=0):
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal(LEAD + (NX,)), rng.standard_normal(LEAD + (NU,)),
            rng.uniform(0.05, 0.2, LEAD), 0.3 * rng.standard_normal(LEAD + (NX,)),
            0.3 * rng.standard_normal(LEAD + (NU,)))


def _over_lead(fn, n_args):
    for _ in LEAD:
        fn = jax.vmap(fn, in_axes=(0,) * n_args)
    return jax.jit(fn)


def _jax_ineq(x, u):
    return jnp.stack([x[0] * u[0] - 0.5, -x[1] - 0.9])


def _jax_eq(x, u):
    return x[2] + u[1] ** 2 - 0.1


def _torch_ineq(x, u):
    return torch.cat([x[..., :1] * u[..., :1] - 0.5, -x[..., 1:2] - 0.9], dim=-1)


def _torch_eq(x, u):
    return x[..., 2:3] + u[..., 1:2] ** 2 - 0.1


def _stage_constraints():
    return {
        "functional": (
            jcon.FunctionalStageConstraint(neq=1, nineq=2, eq_fn=_jax_eq, ineq_fn=_jax_ineq),
            tcon.FunctionalStageConstraint(neq=1, nineq=2, eq_fn=_torch_eq, ineq_fn=_torch_ineq),
        ),
        "functional_one_row_no_trailing_dim": (
            jcon.FunctionalStageConstraint(nineq=1, ineq_fn=lambda x, u: -x[1] - 0.9),
            tcon.FunctionalStageConstraint(nineq=1, ineq_fn=lambda x, u: -x[..., 1] - 0.9),
        ),
        "base": (jcon.StageConstraint(), tcon.StageConstraint()),
    }


def _terminal_constraints(seed=1):
    rng = np.random.default_rng(seed)
    S, Qf = _psd(rng, NX), _psd(rng, NX)
    return {
        "ball": (jcon.TerminalBall(S=jnp.asarray(S), gamma=0.7),
                 tcon.TerminalBall(S=torch.from_numpy(S), gamma=0.7)),
        "ball_from_cost": (
            jcon.terminal_ball_from_cost(jc.QuadraticFinalStateCost(Qf=jnp.asarray(Qf)), 0.3),
            tcon.terminal_ball_from_cost(tc.QuadraticFinalStateCost(Qf=torch.from_numpy(Qf)), 0.3),
        ),
        "equality": (jcon.terminal_equality(NX), tcon.terminal_equality(NX)),
        "partial_equality": (jcon.terminal_partial_equality([2, 0]),
                             tcon.terminal_partial_equality([2, 0])),
    }


def _costs(seed=2):
    rng = np.random.default_rng(seed)
    Q, R = _psd(rng, NX), _psd(rng, NU)
    j, t = jnp.asarray, torch.from_numpy
    jsc, tsc = _stage_constraints()["functional"]
    return {
        "state": (jc.QuadraticStateCost(Q=j(Q)), tc.QuadraticStateCost(Q=t(Q))),
        "control": (jc.QuadraticControlCost(R=j(R)), tc.QuadraticControlCost(R=t(R))),
        "min_time_regularized": (jc.MinimumTimeRegularized(weight=1.5, reg=0.2),
                                 tc.MinimumTimeRegularized(weight=1.5, reg=0.2)),
        "min_time_quadratic": (jc.MinTimeQuadratic(time_weight=2.0, Q=j(Q), R=j(R)),
                               tc.MinTimeQuadratic(time_weight=2.0, Q=t(Q), R=t(R))),
        "min_time_quadratic_controls": (jc.MinTimeQuadraticControls(0.5, R=j(R)),
                                        tc.MinTimeQuadraticControls(0.5, R=t(R))),
        "min_time_quadratic_states": (jc.MinTimeQuadraticStates(0.5, Q=j(Q)),
                                      tc.MinTimeQuadraticStates(0.5, Q=t(Q))),
        "gain_scheduled": (
            jc.MinTimeQuadraticGainScheduled(time_weight=1.2, Q=j(Q), R=j(R), radius=0.8,
                                             sharpness=6.0),
            tc.MinTimeQuadraticGainScheduled(time_weight=1.2, Q=t(Q), R=t(R), radius=0.8,
                                             sharpness=6.0),
        ),
        "l1_soft": (jc.L1SoftConstraintCost(constraint=jsc, weight=3.0),
                    tc.L1SoftConstraintCost(constraint=tsc, weight=3.0)),
    }


@pytest.mark.parametrize("name", list(_stage_constraints()))
def test_stage_constraint_rows_equal_the_reference(name):
    jcn, tcn = _stage_constraints()[name]
    pts = _points()
    tp = [torch.from_numpy(a) for a in pts]
    for fn in ("eq", "ineq"):
        want = np.asarray(_over_lead(lambda *a, f=fn: getattr(jcn, f)(*a), 5)(*pts))
        got = to_np(getattr(tcn, fn)(*tp))
        assert got.shape == want.shape == LEAD + (getattr(jcn, "neq" if fn == "eq" else "nineq"),)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", list(_terminal_constraints()))
def test_terminal_constraint_rows_equal_the_reference(name):
    jcn, tcn = _terminal_constraints()[name]
    x, _, _, xref, _ = _points(3)
    for fn in ("eq", "ineq"):
        want = np.asarray(_over_lead(lambda *a, f=fn: getattr(jcn, f)(*a), 2)(x, xref))
        got = to_np(getattr(tcn, fn)(torch.from_numpy(x), torch.from_numpy(xref)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (tcn.neq, tcn.nineq) == (jcn.neq, jcn.nineq)


@pytest.mark.parametrize("name", list(_costs()))
def test_new_costs_equal_the_reference(name):
    jcost, tcost = _costs()[name]
    pts = _points(4)
    tp = [torch.from_numpy(a) for a in pts]
    want = np.asarray(_over_lead(jcost.stage, 5)(*pts))
    np.testing.assert_allclose(to_np(tcost.stage(*tp)), want, rtol=0, atol=TOL)
    assert tcost.convex == jcost.convex and tcost.quadratic == jcost.quadratic
    if name in ("state", "control"):
        want_r = np.asarray(_over_lead(jcost.stage_residual, 5)(*pts))
        np.testing.assert_allclose(to_np(tcost.stage_residual(*tp)), want_r, rtol=0, atol=TOL)
    # the same object rebuilt from the JAX object's numpy spec
    spec = obj_spec(jcost, **({"constraint": obj_spec(
        jcost.constraint, eq_fn=_torch_eq, ineq_fn=_torch_ineq)} if name == "l1_soft" else {}))
    rebuilt = convert.cost_from_numpy(spec, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(to_np(rebuilt.stage(*tp)), want, rtol=0, atol=TOL)


def test_composite_cost_derives_convex_as_the_reference():
    jg, tg = _costs()["gain_scheduled"]
    js, ts = _costs()["state"]
    for parts in ((0,), (1,), (0, 1)):
        jcomp = jc.CompositeCost(costs=tuple((jg, js)[i] for i in parts))
        tcomp = tc.CompositeCost(costs=tuple((tg, ts)[i] for i in parts))
        assert (tcomp.convex, tcomp.quadratic) == (jcomp.convex, jcomp.quadratic)


@pytest.mark.parametrize("name", ["ball", "equality", "partial_equality"])
def test_terminal_constraints_rebuild_from_numpy_specs(name):
    jcn, _ = _terminal_constraints()[name]
    tcn = convert.constraint_from_numpy(obj_spec(jcn), dtype=torch.float64, device="cpu")
    x, _, _, xref, _ = _points(5)
    for fn in ("eq", "ineq"):
        want = np.asarray(_over_lead(lambda *a, f=fn: getattr(jcn, f)(*a), 2)(x, xref))
        got = to_np(getattr(tcn, fn)(torch.from_numpy(x), torch.from_numpy(xref)))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_riccati_terminal_cost_still_raises_by_name():
    """Ported with ``ops/matrix_eq.py`` (the LQR family): the double
    integrator's Qf is the CARE's solution (held to the JAX one in
    tests/test_torch_matrix_eq.py)."""
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous

    z = torch.zeros(2, dtype=torch.float64)
    cost = tc.riccati_terminal_cost(DoubleIntegratorContinuous(), z, z[:1],
                                    torch.eye(2, dtype=torch.float64),
                                    torch.eye(1, dtype=torch.float64))
    # A = [[0, 1], [0, 0]], B = e2, Q = I, R = 1: X = [[√3, 1], [1, √3]]
    s3 = np.sqrt(3.0)
    np.testing.assert_allclose(cost.Qf.numpy(), [[s3, 1.0], [1.0, s3]], rtol=0, atol=1e-10)


# --------------------------------------------------------------------------
# the stage preprocessor (tests/test_preprocessor_and_threaded_plant.py:31-75)
# --------------------------------------------------------------------------

def test_preprocessed_cost_and_constraint_share_quantity():
    from control_box_rst_tpu_torch.ocp import (
        PreprocessedStageConstraint,
        PreprocessedStageCost,
        StagePreprocessor,
    )

    pre = StagePreprocessor(fn=lambda x, u, dt: x[..., 1:2] ** 2)
    cost = PreprocessedStageCost(pre=pre, term=lambda q, x, u, dt, xref, uref: 0.5 * q)
    con = PreprocessedStageConstraint(pre=pre, nineq=1, ineq_term=lambda q, x, u, dt: q - 0.25)
    x = torch.tensor([[0.3, 0.8], [0.1, -0.5]], dtype=torch.float64)
    u = torch.tensor([[0.1], [0.2]], dtype=torch.float64)
    dt = torch.full((2,), 0.1, dtype=torch.float64)
    np.testing.assert_allclose(to_np(cost.stage(x, u, dt, x, u)), [0.5 * 0.64, 0.5 * 0.25], atol=TOL)
    np.testing.assert_allclose(to_np(con.ineq(x, u, dt, x, u)), [[0.64 - 0.25], [0.0]], atol=TOL)
    assert to_np(cost.final(x, x)).shape == (2,)


def test_preprocessed_constraint_enforced_in_solve():
    """|x₁|² ≤ 0.09 through the preprocessor, SQP on both sides: the same
    trajectory (1e-8), the constraint active and respected."""
    from control_box_rst_tpu.models import DoubleIntegratorContinuous as JDI
    from control_box_rst_tpu.ocp import (
        Bounds,
        PreprocessedStageConstraint,
        QuadraticFormCost,
        StagePreprocessor,
        finite_differences_grid,
        transcribe,
    )
    from control_box_rst_tpu.ocp.problem import Trajectory as JT
    from control_box_rst_tpu.solvers import SQPConfig as JSQP
    from control_box_rst_tpu.solvers import sqp_solve as jsqp
    from control_box_rst_tpu_torch.ocp import (
        PreprocessedStageConstraint as TPSC,
        StagePreprocessor as TSP,
    )
    from control_box_rst_tpu_torch.ocp.problem import Trajectory
    from control_box_rst_tpu_torch.solvers import SQPConfig, sqp_solve

    from torch_port_util import ocp_spec

    pre = StagePreprocessor(fn=lambda x, u, dt: x[1] ** 2)
    con = PreprocessedStageConstraint(pre=pre, nineq=1,
                                      ineq_term=lambda q, x, u, dt: jnp.array([q - 0.09]))
    x0 = jnp.array([1.0, 0.0])
    ocp = transcribe(
        JDI(), finite_differences_grid(20, fd_scheme="crank_nicolson"),
        QuadraticFormCost(Q=jnp.eye(2), R=0.1 * jnp.eye(1)),
        bounds=Bounds.unbounded(2, 1).with_u(-1.0, 1.0).with_dt(0.1, 0.1), x0=x0, stage_con=con,
    )
    traj0 = JT.linear_interp(x0, jnp.zeros(2), 20, 1, 0.1)
    want = jax.jit(lambda t: jsqp(ocp, t, JSQP(max_iter=15)))(traj0)

    tpre = TSP(fn=lambda x, u, dt: x[..., 1:2] ** 2)
    spec = ocp_spec(ocp, stage_con=dict(
        kind="PreprocessedStageConstraint", nineq=1, pre=tpre,
        ineq_term=lambda q, x, u, dt: q - 0.09))
    tocp = convert.ocp_from_numpy(spec, dtype=torch.float64, device="cpu")
    assert isinstance(tocp.stage_con, TPSC) and tocp.ng == 1
    t0 = Trajectory.linear_interp(torch.tensor([1.0, 0.0], dtype=torch.float64),
                                  torch.zeros(2, dtype=torch.float64), 20, 1, 0.1)
    got = sqp_solve(tocp, t0, SQPConfig(max_iter=15))
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(to_np(got.traj.X), np.asarray(want.traj.X), rtol=0, atol=1e-8)
    v = to_np(got.traj.X[:, 1])
    assert np.all(np.abs(v) <= 0.3 + 5e-3), v


# --------------------------------------------------------------------------
# the generic NLP interface (tests/test_simple_nlp.py)
# --------------------------------------------------------------------------

def _nlp_cases():
    """name -> (JAX kwargs, port kwargs, z0, analytic optimum, atol)."""
    return {
        "rosenbrock": (
            dict(objective=lambda z: (1 - z[0]) ** 2 + 100.0 * (z[1] - z[0] ** 2) ** 2),
            dict(objective=lambda z: (1 - z[..., 0]) ** 2 + 100.0 * (z[..., 1] - z[..., 0] ** 2) ** 2),
            [-1.2, 1.0], [1.0, 1.0], 1e-4),
        "equality": (
            dict(objective=lambda z: z @ z, eq=lambda z: z[0] + z[1] - 1.0, neq=1),
            dict(objective=lambda z: (z * z).sum(-1), eq=lambda z: z[..., 0] + z[..., 1] - 1.0, neq=1),
            [3.0, -1.0], [0.5, 0.5], 1e-6),
        "inequality": (
            dict(objective=lambda z: (z[0] - 2.0) ** 2, ineq=lambda z: z[0] - 1.0, nineq=1),
            dict(objective=lambda z: (z[..., 0] - 2.0) ** 2, ineq=lambda z: z[..., 0] - 1.0, nineq=1),
            [0.0], [1.0], 1e-6),
        "bounds": (
            dict(objective=lambda z: (z[0] - 2.0) ** 2, lb=jnp.array([-1.0]), ub=jnp.array([0.5])),
            dict(objective=lambda z: (z[..., 0] - 2.0) ** 2, lb=torch.tensor([-1.0], dtype=torch.float64),
                 ub=torch.tensor([0.5], dtype=torch.float64)),
            [0.0], [0.5], 1e-6),
    }


@pytest.mark.parametrize("name", list(_nlp_cases()))
def test_solve_nlp_equals_the_reference(name):
    from control_box_rst_tpu.solvers import QPConfig as JQP
    from control_box_rst_tpu.solvers import SQPConfig as JSQP
    from control_box_rst_tpu.solvers.simple_nlp import nlp_solution as jsol
    from control_box_rst_tpu.solvers.simple_nlp import solve_nlp as jsolve
    from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig
    from control_box_rst_tpu_torch.solvers.simple_nlp import nlp_solution, solve_nlp

    jkw, tkw, z0, z_star, atol = _nlp_cases()[name]
    jcfg = JSQP(max_iter=50, qp=JQP(max_iter=1000, tol=1e-12), psd_clamp=True)
    want = jax.jit(lambda z: jsolve(z0=z, cfg=jcfg, **jkw))(jnp.asarray(z0))
    got = solve_nlp(z0=torch.tensor(z0, dtype=torch.float64), cfg=SQPConfig(
        max_iter=50, qp=QPConfig(max_iter=1000, tol=1e-12), psd_clamp=True), **tkw)
    np.testing.assert_allclose(to_np(nlp_solution(got)), np.asarray(jsol(want)), rtol=0, atol=1e-8)
    np.testing.assert_allclose(to_np(nlp_solution(got)), z_star, rtol=0, atol=atol)
    assert int(got.iterations) == int(want.iterations)


def test_solve_nlp_batch_of_initial_points():
    """A batch of z0 (the counterpart of the reference's ``jax.vmap``)."""
    from control_box_rst_tpu_torch.solvers import SQPConfig
    from control_box_rst_tpu_torch.solvers.simple_nlp import nlp_solution, solve_nlp

    z0 = torch.tensor([[0.0, 0.0], [5.0, -3.0]], dtype=torch.float64)
    res = solve_nlp(lambda z: ((z - 1.0) ** 2).sum(-1), z0, cfg=SQPConfig(max_iter=10))
    np.testing.assert_allclose(to_np(nlp_solution(res)), 1.0, atol=1e-6)
