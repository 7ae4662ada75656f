"""PyTorch port vs JAX package: the interior-point solver's entry points
and the IP controller.

  - ``make_batched_ip_solver`` on ``entry.flagship_ip`` (config 1 at N=12,
    float32; on the CPU the Schur solve's plain version answers) against
    the JAX solves per lane: two float32 solves stop at tol 7e-6 on either
    side of the optimum, so the port's is held to be as close to the JAX
    float64 solve as the JAX float32 one is (2x + 1e-4), status equal; the
    iteration counts are not compared: near tol 7e-6 the float32 exit test
    sits at the noise floor, and a lane's count moves by up to a third
    (21 against 15 seen); no kernel is launched on the CPU;
  - ``PredictiveController(solver='ip')`` in ``run_closed_loop`` against
    ``jax.jit(jax.vmap(run_closed_loop))`` of the JAX controller: config 1's
    OCP at N=10, 15 steps, 3 lanes, float64 — x_true, u, ok and every info
    field to 1e-6, the carry's duals (y_box = z_uw − z_lw) included through
    the next steps; the reference test's own asserts (|u| <= 1, the loop
    tracks the SQP controller's);
  - ``entry.rollouts_ip`` builds that controller for config 5; the new
    entry points refuse the CPU unless asked.
"""
import jax
import pytest
import jax.numpy as jnp
import numpy as np
import torch

from control_box_rst_tpu.ocp.problem import Trajectory as JT
from control_box_rst_tpu.solvers import IPConfig as JIP
from control_box_rst_tpu.solvers import ip_solve as jip

from torch_port_util import jax_flagship, to_np, torch_ocp_like

torch.set_num_threads(1)


def test_batched_ip_solver_on_config_1_in_float32():
    """``make_batched_ip_solver`` on ``entry.flagship_ip`` at N=12, float32:
    the port (the Schur solve's plain version on the CPU) against the JAX
    float32 solve per lane. No kernel is launched on the CPU."""
    from control_box_rst_tpu_torch import entry
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk
    from control_box_rst_tpu_torch.parallel import make_batched_ip_solver

    from torch_port_util import jax_flagship

    N = 12
    x0s = np.random.default_rng(0).uniform(-1, 1, (4, 2)).astype(np.float32)
    ocp, cfg = entry.flagship_ip(N, device="cpu")
    assert (cfg.tol, cfg.max_iter) == (7e-6, 80)
    with jax.enable_x64(False):
        jocp, _ = jax_flagship(N, jnp.float32)

        def one(x0):
            o = jocp.replace(bc=jocp.bc.replace(x0=x0))
            r = jip(o, JT.linear_interp(x0, jnp.zeros(2, jnp.float32), N, 1, 0.1),
                    JIP(tol=cfg.tol, max_iter=cfg.max_iter))
            return r.traj.U, r.status, r.iterations

        U_j, st_j, it_j = (np.asarray(a) for a in jax.jit(jax.vmap(one))(jnp.asarray(x0s)))
    assert U_j.dtype == np.float32
    jocp64, _ = jax_flagship(N, jnp.float64)

    def one64(x0):
        o = jocp64.replace(bc=jocp64.bc.replace(x0=x0))
        return jip(o, JT.linear_interp(x0, jnp.zeros(2), N, 1, 0.1), JIP(max_iter=80)).traj.U

    U_64 = np.asarray(jax.jit(jax.vmap(one64))(jnp.asarray(x0s, jnp.float64)))
    bk.reset_launch_counts()
    U, obj, status, iters = make_batched_ip_solver(ocp, cfg, device="cpu")(x0s)
    assert U.dtype == torch.float32 and U.shape == (4, N, 1)
    assert not any(bk.LAUNCHES.values())
    err_ref = np.abs(U_j - U_64).max()
    assert np.abs(to_np(U) - U_64).max() <= 2.0 * err_ref + 1e-4, err_ref
    np.testing.assert_array_equal(to_np(status), st_j)
    assert int(iters.max()) <= cfg.max_iter and int(iters.min()) >= 1


def test_ip_controller_closed_loop_equals_the_reference():
    from control_box_rst_tpu.control import PredictiveController as JC
    from control_box_rst_tpu.models import DoubleIntegratorContinuous as JDI
    from control_box_rst_tpu.sim import SimulatedPlant as JPlant
    from control_box_rst_tpu.sim import run_closed_loop as jrun
    from control_box_rst_tpu.solvers import SQPConfig as JSQP
    from control_box_rst_tpu_torch.control import PredictiveController
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.sim import SimulatedPlant, run_closed_loop
    from control_box_rst_tpu_torch.solvers import IPConfig, SQPConfig

    N, T = 10, 15
    x0s = np.array([[1.5, 0.0], [-0.8, 0.4], [0.3, -0.9]])
    jocp, _ = jax_flagship(N, jnp.float64)
    jplant = JPlant(system=JDI())
    mk = lambda solver: JC(nx=2, nu=1, ocp=jocp, dt=0.1, solver=solver,
                           cfg=JSQP(max_iter=6), ip_cfg=JIP(max_iter=40))
    want = jax.jit(jax.vmap(lambda x: jrun(jplant, mk("ip"), x, T_steps=T, dt=0.1)))(x0s)
    want_sqp = jax.jit(jax.vmap(lambda x: jrun(jplant, mk("sqp"), x, T_steps=T, dt=0.1)))(x0s)
    ctrl = PredictiveController(nx=2, nu=1, ocp=torch_ocp_like(jocp, "float64"), dt=0.1,
                                solver="ip", cfg=SQPConfig(max_iter=6),
                                ip_cfg=IPConfig(max_iter=40), device="cpu", dtype=torch.float64)
    got = run_closed_loop(SimulatedPlant(system=DoubleIntegratorContinuous()), ctrl,
                          torch.as_tensor(x0s), T, 0.1)
    for name in ("x_true", "u", "ok"):
        np.testing.assert_allclose(to_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert set(got.info) == set(want.info)
    for name, v in want.info.items():
        np.testing.assert_allclose(to_np(got.info[name]), np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=name)
    assert bool(got.ok.all()) and float(got.u.abs().max()) <= 1.0 + 1e-9
    np.testing.assert_allclose(to_np(got.u), np.asarray(want_sqp.u), atol=2e-4)


def test_rollouts_ip_builds_the_ip_controller_of_config_5():
    from control_box_rst_tpu_torch import entry

    ctrl, plant, T, dt = entry.rollouts_ip(N=10, device="cpu")
    assert ctrl.solver == "ip" and (ctrl.ip_cfg.tol, ctrl.ip_cfg.max_iter) == (7e-6, 80)
    assert (T, dt) == (20, 0.1) and ctrl.ocp.N == 10


def test_ip_entry_points_refuse_the_cpu_unless_asked():
    from control_box_rst_tpu_torch import entry
    from control_box_rst_tpu_torch.parallel import make_batched_ip_solver

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is allowed to run")
    for fn in (entry.flagship_ip, entry.constrained_di, entry.rollouts_ip):
        with pytest.raises(RuntimeError):
            fn()
    with pytest.raises(RuntimeError):
        make_batched_ip_solver(*entry.flagship_ip(N=4, device="cpu"), device=None)
