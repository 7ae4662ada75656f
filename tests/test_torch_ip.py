"""PyTorch port vs JAX package: the interior-point solver.

The seven problems of tests/test_ip_solver.py go through
``control_box_rst_tpu.solvers.ip_solve`` (under ``jax.jit``, lanes by
``jax.vmap``) and the port's batch-first ``ip_solve`` on the same numpy
inputs, float64. Held: W, the slacks and every dual (y_dyn, y_gen, z_lw,
z_uw) to 1e-8, iterations and status equal, and each reference test's own
asserts:
  - box-bounded (active input bounds): the same KKT point as SQP, bounds
    respected and active;
  - general rows and terminal equality (the constrained double
    integrator): the state row active and never violated, x_N = 0;
  - unconstrained: Newton, at most 12 iterations;
  - a batch equal to single lanes (the same lanes solved alone, 1e-12);
  - the infeasible problem: INFEASIBLE or EARLY_TERMINATED, everything
    finite. Its duals grow without bound (|y_dyn| ~ 2e9 after 80
    iterations), and the rounding of two implementations grows with them:
    after 5 iterations W and the duals agree to 1e-8, after 80 iterations
    W to 1e-5, the objective to 1e-5 and the duals to 1e-3 relative, status
    and iterations equal;
  - Van der Pol by multiple shooting (per-lane J, K, H every iteration);
  - complementarity: bound duals non-negative, comp_res < 1e-7, active
    rows carry multipliers.
The slice's entry points and the IP controller: tests/test_torch_ip_controller.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.core.types import SolverStatus
from control_box_rst_tpu.models import SerialIntegratorSystem, VanDerPolOscillator
from control_box_rst_tpu.ocp import (
    Bounds,
    CompositeCost,
    QuadraticFinalStateCost,
    QuadraticFormCost,
    finite_differences_grid,
    multiple_shooting_grid,
    transcribe,
)
from control_box_rst_tpu.ocp.constraints import FunctionalStageConstraint, terminal_equality
from control_box_rst_tpu.ocp.problem import Trajectory as JT
from control_box_rst_tpu.solvers import IPConfig as JIP
from control_box_rst_tpu.solvers import SQPConfig as JSQP
from control_box_rst_tpu.solvers import ip_solve as jip
from control_box_rst_tpu.solvers import sqp_solve as jsqp
from control_box_rst_tpu_torch import convert
from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.solvers import IPConfig, ip_solve

from torch_port_util import ocp_spec, to_np

torch.set_num_threads(1)
F64 = torch.float64
TOL = 1e-8


def _di_ocp(x0, N=20, umax=1.0, Qf=5.0, stage_con=None, term_con=None):
    costs = [QuadraticFormCost(Q=jnp.eye(2), R=0.1 * jnp.eye(1))]
    if Qf is not None:
        costs.append(QuadraticFinalStateCost(Qf=Qf * jnp.eye(2)))
    return transcribe(
        SerialIntegratorSystem(nx=2, nu=1), finite_differences_grid(N=N),
        CompositeCost(costs=tuple(costs)), bounds=Bounds.unbounded(2, 1).with_u(-umax, umax),
        x0=jnp.asarray(x0), stage_con=stage_con, term_con=term_con,
    )


def _vdp_ocp(x0):
    return transcribe(
        VanDerPolOscillator(), multiple_shooting_grid(N=20, integrator="rk4"),
        CompositeCost(costs=(QuadraticFormCost(Q=jnp.eye(2), R=0.1 * jnp.eye(1)),
                             QuadraticFinalStateCost(Qf=5.0 * jnp.eye(2)))),
        bounds=Bounds.unbounded(2, 1).with_u(-2.0, 2.0), x0=jnp.asarray(x0))


def _unconstrained_ocp(x0):
    return transcribe(
        SerialIntegratorSystem(nx=2, nu=1), finite_differences_grid(N=15),
        CompositeCost(costs=(QuadraticFormCost(Q=jnp.eye(2), R=0.1 * jnp.eye(1)),
                             QuadraticFinalStateCost(Qf=2.0 * jnp.eye(2)))),
        bounds=Bounds.unbounded(2, 1), x0=jnp.asarray(x0))


_ROW = FunctionalStageConstraint(nineq=1, ineq_fn=lambda x, u: -x[1] - 0.9)
_ROW_SPEC = dict(kind="FunctionalStageConstraint", nineq=1,
                 ineq_fn=lambda x, u: -x[..., 1:2] - 0.9)

# name -> (make JAX OCP from x0, x0s [B, 2], dt of the guess, IPConfig kwargs,
#          stage_con spec, term_con spec)
PROBLEMS = {
    "box_bounded": (lambda x0: _di_ocp(x0), [[2.0, 0.0]], 0.1, dict(max_iter=60), None, None),
    "general_rows_terminal_equality": (
        lambda x0: _di_ocp(x0, N=25, Qf=None, stage_con=_ROW, term_con=terminal_equality(2)),
        [[2.0, 0.0]], 0.25, dict(max_iter=100), _ROW_SPEC,
        dict(kind="TerminalEquality", neq=2)),
    "unconstrained_newton": (lambda x0: _unconstrained_ocp(x0), [[1.0, -0.5]], 0.1, {},
                             None, None),
    "batch": (lambda x0: _di_ocp(x0), np.random.RandomState(0).uniform(-2, 2, (8, 2)), 0.1,
              dict(max_iter=60), None, None),
    "infeasible": (lambda x0: _di_ocp(x0, N=20, Qf=None, term_con=terminal_equality(2)),
                   [[2.0, 0.0]], 0.1, dict(max_iter=80), None,
                   dict(kind="TerminalEquality", neq=2)),
    "van_der_pol": (lambda x0: _vdp_ocp(x0), [[1.0, 0.5]], 0.1, dict(max_iter=80), None, None),
    "complementarity": (lambda x0: _di_ocp(x0), [[2.0, 0.0]], 0.1, {}, None, None),
}
FIELDS = ("W", "S", "y_dyn", "y_gen", "z_lw", "z_uw")


def _port_solve(name, jocp, x0s, kw):
    _, _, dt, _, sc, tc = PROBLEMS[name]
    tocp = convert.ocp_from_numpy(ocp_spec(jocp, stage_con=sc, term_con=tc), dtype=F64,
                                  device="cpu")
    x0 = torch.as_tensor(x0s)
    return ip_solve(tocp.replace(bc=tocp.bc.replace(x0=x0)),
                    Trajectory.linear_interp(x0, torch.zeros(2, dtype=F64), jocp.N, 1, dt),
                    IPConfig(**kw))


def _solve_both(name, max_iter=None):
    make, x0s, dt, kw, _, _ = PROBLEMS[name]
    if max_iter is not None:
        kw = dict(kw, max_iter=max_iter)
    x0s = np.asarray(x0s, np.float64)
    jocp = make(x0s[0])
    N = jocp.N

    def one(x0):
        o = jocp.replace(bc=jocp.bc.replace(x0=x0))
        return jip(o, JT.linear_interp(x0, jnp.zeros(2), N, 1, dt), JIP(**kw))

    want = jax.jit(jax.vmap(one))(jnp.asarray(x0s))
    return jocp, want, _port_solve(name, jocp, x0s, kw)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_ip_solve_equals_the_reference(name):
    jocp, want, got = _solve_both(name)
    tol = dict(rtol=0, atol=TOL) if name != "infeasible" else dict(rtol=1e-3, atol=1e-5)
    for f in FIELDS:
        np.testing.assert_allclose(to_np(getattr(got, f)), np.asarray(getattr(want, f)),
                                   err_msg=f, **tol)
    for f in ("iterations", "status"):
        np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(getattr(want, f)))
    rtol = 1e-9 if name != "infeasible" else 1e-5
    for f in ("objective", "mu"):
        np.testing.assert_allclose(to_np(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=1e-12, err_msg=f)
    U, X, status = to_np(got.traj.U), to_np(got.traj.X), to_np(got.status)
    converged = int(SolverStatus.CONVERGED)
    if name == "box_bounded":
        assert (status == converged).all()
        assert U.max() <= 1.0 + 1e-9 and U.min() >= -1.0 - 1e-9 and U.min() < -1.0 + 1e-4
        x0 = jnp.asarray([2.0, 0.0])
        r_sqp = jax.jit(lambda t: jsqp(jocp, t, JSQP(max_iter=20)))(
            JT.linear_interp(x0, jnp.zeros(2), 20, 1, 0.1))
        np.testing.assert_allclose(U[0], np.asarray(r_sqp.traj.U), atol=1e-5)
    elif name == "general_rows_terminal_equality":
        assert (status == converged).all()
        assert X[..., 1].min() >= -0.9 - 1e-7 and X[..., 1].min() < -0.9 + 1e-4
        np.testing.assert_allclose(X[:, -1], 0.0, atol=1e-7)
    elif name == "unconstrained_newton":
        assert (status == converged).all() and int(got.iterations.max()) <= 12
    elif name == "batch":
        assert (status == converged).all()
    elif name == "infeasible":
        assert int(status[0]) in (int(SolverStatus.INFEASIBLE), int(SolverStatus.EARLY_TERMINATED))
        assert np.isfinite(to_np(got.W)).all() and np.isfinite(to_np(got.objective)).all()
    elif name == "van_der_pol":
        assert (status == converged).all()
    elif name == "complementarity":
        assert (status == converged).all()
        assert (to_np(got.z_lw) >= 0).all() and (to_np(got.z_uw) >= 0).all()
        assert float(got.comp_res.max()) < 1e-7
        active = U[0, :, 0] < -1.0 + 1e-6
        assert active.any() and (to_np(got.z_lw)[0, :-1, 2][active] > 1e-6).all()


def test_infeasible_problem_first_iterations_equal_the_reference():
    _, want, got = _solve_both("infeasible", max_iter=5)
    for f in FIELDS:
        np.testing.assert_allclose(to_np(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=0, atol=TOL, err_msg=f)
    assert int(got.iterations[0]) == int(want.iterations[0]) == 5


def test_batch_lanes_equal_single_solves():
    make, x0s, _, kw, _, _ = PROBLEMS["batch"]
    jocp = make(x0s[0])
    batch = _port_solve("batch", jocp, x0s, kw)
    for i in (0, 3, 7):
        single = _port_solve("batch", jocp, x0s[i:i + 1], kw)
        np.testing.assert_allclose(to_np(batch.W[i]), to_np(single.W[0]), rtol=0, atol=1e-12)
        assert int(batch.iterations[i]) == int(single.iterations[0])
