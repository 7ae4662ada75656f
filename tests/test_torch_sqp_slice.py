"""PyTorch port vs JAX package: the slice as a whole, float32.

``flagship(N=8)`` through the port's ``make_batched_solver(device="cpu")``
with the fused backend (on the CPU the plain version stands behind the
kernel's wrapper) against the JAX ``sqp_solve`` called UNBATCHED per lane
under ``jax.jit`` (there ``custom_vmap`` takes the per-lane reference, the
semantics the port follows).

Two traps on the JAX side, both of which silently switch the one-shot branch
off because it requires float32: under the x64 test configuration the OCP is
built in float64, and ``Trajectory.linear_interp(…, dt)`` yields float64
``dts``. Both the OCP and ``traj0`` are cast to float32 here, and the test
asserts that an easy lane reports ``iterations == 1``.

Tolerances: U atol 2e-4 and objective rtol 1e-4 — both sides stop at the same
KKT tolerances (1e-4 / 1e-5), so they agree to float32 roundoff compounded
over the ADMM rounds, well inside what those tolerances leave open; status
must be equal. The SQP iteration count is compared per lane too, with one
allowance: the exit tests compare float32 residuals near their noise floor
with the tolerances, so a lane whose residual sits at a tolerance takes one
iteration more or fewer on one side (XLA fuses multiply-adds, eager PyTorch
does not). Measured on these 22 lanes: 19 equal, 3 off by one, in both
directions, with U equal to 4e-5 on all. The test holds every lane to
|Δiterations| <= 1 and at least 80 % of the lanes to equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.ocp.problem import Trajectory as JaxTrajectory
from control_box_rst_tpu.solvers.sqp import sqp_solve as jax_sqp_solve
from control_box_rst_tpu_torch.entry import flagship
from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.parallel import make_batched_solver
from control_box_rst_tpu_torch.solvers.sqp import SQPConfig, sqp_solve
from control_box_rst_tpu_torch.solvers.stage_qp import QPConfig

from torch_port_util import cast_tree, jax_flagship, to_np, torch_ocp_like

torch.set_num_threads(1)
N = 8
# lanes with no active bound, with active bounds, and far enough out that the
# one-shot misses its tolerances and the outer SQP loop takes over
_rng = np.random.default_rng(0)
X0S = np.concatenate([
    np.array([[0.1, 0.0], [1.0, 0.0]]),
    _rng.uniform(-1.0, 1.0, (10, 2)), _rng.uniform(-2.0, 2.0, (10, 2)),
]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_results():
    ocp, cfg = jax_flagship(N, jnp.float32)
    cfg = cfg.replace(qp=cfg.qp.replace(backend="fused"))

    @jax.jit
    def solve_one(x0):
        o = ocp.replace(bc=ocp.bc.replace(x0=x0))
        traj0 = cast_tree(
            JaxTrajectory.linear_interp(x0, o.refs.xref[-1], N, 1, 0.1), jnp.float32
        )
        r = jax_sqp_solve(o, traj0, cfg)
        return r.traj.U, r.objective, r.status, r.iterations, r.qp_iters

    outs = [solve_one(jnp.asarray(x0)) for x0 in X0S]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(5)]


def test_flagship_slice_matches_jax(jax_results):
    U_j, obj_j, status_j, iters_j, _ = jax_results
    assert U_j.dtype == np.float32
    assert iters_j[0] == 1, "the JAX side did not take the one-shot branch"
    assert iters_j.max() >= 2, "no lane fell through to the outer loop"
    assert (np.abs(U_j) > 0.999).any(), "no lane has an active bound"

    ocp, cfg = flagship(N=N, device="cpu")
    cfg = cfg.replace(qp=cfg.qp.replace(backend="fused"))
    solver = make_batched_solver(ocp, cfg, dt_init=0.1, device="cpu")
    U, obj, status, iters = solver(X0S)
    assert U.dtype == torch.float32 and U.shape == (len(X0S), N, 1)
    np.testing.assert_array_equal(to_np(status), status_j)
    d_it = np.abs(to_np(iters).astype(int) - iters_j.astype(int))
    assert d_it.max() <= 1, (to_np(iters), iters_j)
    assert (d_it == 0).mean() >= 0.8, (to_np(iters), iters_j)
    np.testing.assert_allclose(to_np(U), U_j, rtol=0, atol=2e-4)
    np.testing.assert_allclose(to_np(obj), obj_j, rtol=1e-4, atol=0)
    assert status.dtype == torch.int32 and bool((status == 1).all())


def test_batched_solve_equals_per_lane_solve():
    """A lane's answer does not depend on its neighbours: the batch against
    one-lane batches (exact: same arithmetic per lane)."""
    ocp, cfg = flagship(N=N, device="cpu")
    cfg = cfg.replace(qp=cfg.qp.replace(backend="fused"))
    solver = make_batched_solver(ocp, cfg, device="cpu")
    U, obj, status, iters = solver(X0S)
    for i in (0, 15):
        U1, obj1, status1, iters1 = solver(X0S[i:i + 1])
        np.testing.assert_allclose(to_np(U1[0]), to_np(U[i]), rtol=0, atol=1e-6)
        assert int(iters1[0]) == int(iters[i]) and int(status1[0]) == int(status[i])


def test_outer_loop_only_matches_jax():
    """The outer SQP loop by itself (non-fused backend: no one-shot), float64,
    per-lane against JAX: line search, merit, watchdog and freeze. Tolerance
    1e-7: both sides stop their QPs at tol 1e-9 after the same rounds."""
    ocp_j, _ = jax_flagship(N, jnp.float64)
    kw = dict(max_iter=10, tol_stat=1e-6, tol_feas=1e-7)
    qkw = dict(max_iter=400, iters_per_round=50, rho=1.0, tol=1e-9)
    from control_box_rst_tpu.solvers import QPConfig as JQPConfig, SQPConfig as JSQPConfig

    cfg_j = JSQPConfig(qp=JQPConfig(backend="xla", **qkw), **kw)
    x0s = X0S[[1, 15]].astype(np.float64)

    def solve_one(x0):
        o = ocp_j.replace(bc=ocp_j.bc.replace(x0=x0))
        traj0 = JaxTrajectory.linear_interp(x0, o.refs.xref[-1], N, 1, 0.1)
        r = jax_sqp_solve(o, traj0, cfg_j)
        return r.traj.U, r.objective, r.status, r.iterations, r.stat_res, r.feas_res

    out_j = jax.jit(jax.vmap(solve_one))(jnp.asarray(x0s))
    ocp_t = torch_ocp_like(ocp_j, "float64")
    x0t = torch.from_numpy(x0s)
    o = ocp_t.replace(bc=ocp_t.bc.replace(x0=x0t))
    traj0 = Trajectory.linear_interp(x0t, o.refs.xref[-1], N, 1, 0.1)
    r = sqp_solve(o, traj0, SQPConfig(qp=QPConfig(backend="plain", **qkw), **kw))
    np.testing.assert_array_equal(to_np(r.iterations), np.asarray(out_j[3]))
    np.testing.assert_array_equal(to_np(r.status), np.asarray(out_j[2]))
    np.testing.assert_allclose(to_np(r.traj.U), np.asarray(out_j[0]), rtol=0, atol=1e-7)
    np.testing.assert_allclose(to_np(r.objective), np.asarray(out_j[1]), rtol=1e-9)
    assert float(r.feas_res.max()) < 1e-7 and float(r.stat_res.max()) < 1e-6


def test_nonlinear_system_takes_the_unhoisted_path_and_matches_jax():
    """A nonlinear system (pendulum, defined here on both sides) switches the
    hoisting off: J, K and the Hessian blocks are re-evaluated by exact AD in
    every SQP iteration, and the line search does real work. Float64, per
    lane against JAX; U atol 1e-6 (QPs stopped at tol 1e-9 on both sides,
    KKT tolerances 1e-6 / 1e-7)."""
    import dataclasses

    from control_box_rst_tpu.models.base import FunctionalDynamics
    from control_box_rst_tpu.solvers import QPConfig as JQPConfig, SQPConfig as JSQPConfig
    from control_box_rst_tpu_torch.models.base import SystemDynamics

    @dataclasses.dataclass(frozen=True, eq=False)
    class TorchPendulum(SystemDynamics):
        nx: int = 2
        nu: int = 1

        def __call__(self, x, u):
            return torch.stack(
                [x[..., 1], -torch.sin(x[..., 0]) + u[..., 0]], dim=-1
            )

    jax_pendulum = FunctionalDynamics(
        nx=2, nu=1, fn=lambda x, u: jnp.stack([x[1], -jnp.sin(x[0]) + u[0]])
    )
    ocp_j, _ = jax_flagship(N, jnp.float64)
    ocp_t = torch_ocp_like(ocp_j, "float64").replace(system=TorchPendulum())
    ocp_j = ocp_j.replace(system=jax_pendulum)
    assert not ocp_t.lti_structure and not ocp_j.lti_structure

    kw = dict(max_iter=20, tol_stat=1e-6, tol_feas=1e-7)
    qkw = dict(max_iter=400, iters_per_round=50, rho=1.0, tol=1e-9)
    cfg_j = JSQPConfig(qp=JQPConfig(backend="xla", **qkw), **kw)
    x0s = np.array([[1.0, 0.0], [-0.6, 0.8], [2.5, 0.0]])

    def solve_one(x0):
        o = ocp_j.replace(bc=ocp_j.bc.replace(x0=x0))
        traj0 = JaxTrajectory.linear_interp(x0, o.refs.xref[-1], N, 1, 0.1)
        r = jax_sqp_solve(o, traj0, cfg_j)
        return r.traj.U, r.traj.X, r.objective, r.status, r.iterations

    out_j = jax.jit(jax.vmap(solve_one))(jnp.asarray(x0s))
    x0t = torch.from_numpy(x0s)
    o = ocp_t.replace(bc=ocp_t.bc.replace(x0=x0t))
    traj0 = Trajectory.linear_interp(x0t, o.refs.xref[-1], N, 1, 0.1)
    r = sqp_solve(o, traj0, SQPConfig(qp=QPConfig(backend="plain", **qkw), **kw))
    assert int(np.asarray(out_j[4]).max()) >= 3, "expected real SQP iterations"
    np.testing.assert_array_equal(to_np(r.iterations), np.asarray(out_j[4]))
    np.testing.assert_array_equal(to_np(r.status), np.asarray(out_j[3]))
    np.testing.assert_allclose(to_np(r.traj.U), np.asarray(out_j[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(r.traj.X), np.asarray(out_j[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(r.objective), np.asarray(out_j[2]), rtol=1e-8)


def test_warm_started_solve_matches_jax():
    """``sqp_solve(..., warm=SQPWarmStart)`` from a perturbed earlier solution,
    float64, against JAX with the same numpy warm start (carried across by
    ``convert``); U atol 1e-7 as in the outer-loop test."""
    from control_box_rst_tpu.solvers import QPConfig as JQPConfig, SQPConfig as JSQPConfig
    from control_box_rst_tpu.solvers.sqp import SQPWarmStart as JaxWarm
    from control_box_rst_tpu_torch import convert

    ocp_j, _ = jax_flagship(N, jnp.float64)
    x0 = np.array([0.9, -0.4])
    ocp_j = ocp_j.replace(bc=ocp_j.bc.replace(x0=jnp.asarray(x0)))
    ocp_t = torch_ocp_like(ocp_j, "float64")
    rng = np.random.default_rng(11)
    traj = dict(
        X=np.linspace(x0, np.zeros(2), N + 1), U=np.zeros((N, 1)),
        dts=np.full((N,), 0.1),
    )
    W = np.concatenate(
        [traj["X"], np.vstack([0.3 * rng.standard_normal((N, 1)), [[0.0]]]),
         np.vstack([np.full((N, 1), 0.1), [[0.0]]])], axis=1,
    )
    warm = dict(
        W=W, y_dyn=0.1 * rng.standard_normal((N, 2)), y_gen=np.zeros((N + 1, 0)),
        y_box=np.zeros((N + 1, 4)),
    )
    kw = dict(max_iter=10, tol_stat=1e-6, tol_feas=1e-7)
    qkw = dict(max_iter=400, iters_per_round=50, rho=1.0, tol=1e-9)
    cfg_j = JSQPConfig(qp=JQPConfig(backend="xla", **qkw), **kw)
    r_j = jax.jit(lambda t, w: jax_sqp_solve(ocp_j, t, cfg_j, w))(
        JaxTrajectory(**{k: jnp.asarray(v) for k, v in traj.items()}),
        JaxWarm(**{k: jnp.asarray(v) for k, v in warm.items()}),
    )
    r_t = sqp_solve(
        ocp_t, convert.trajectory_from_numpy(traj, torch.float64, "cpu"),
        SQPConfig(qp=QPConfig(backend="plain", **qkw), **kw),
        warm=convert.sqp_warm_start_from_numpy(warm, torch.float64, "cpu"),
    )
    assert int(r_t.iterations) == int(r_j.iterations) and int(r_t.status) == 1
    np.testing.assert_allclose(to_np(r_t.traj.U), np.asarray(r_j.traj.U), rtol=0, atol=1e-7)
    np.testing.assert_allclose(to_np(r_t.y_dyn), np.asarray(r_j.y_dyn), rtol=0, atol=1e-5)
