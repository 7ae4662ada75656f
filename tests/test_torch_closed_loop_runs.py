"""PyTorch port vs JAX package: whole closed-loop runs.

``run_closed_loop`` of the port against ``jax.jit(jax.vmap(run_closed_loop))``
on the same 4 initial states, N=10, T=15, float64, plain backend: x_true, u,
ok and every info field to 1e-6 — on config 1's OCP, once more with the
``OneStepPredictor`` (dead-time compensation), and once on the time-optimal
grid applying the planned sequence in 8 substeps per interval (the per-lane
plan time base). The Levenberg-Marquardt controller against the JAX one (the
closed loop of ``tests/test_lm_solver.py``, 100 steps), one lane per JAX call:
``jax.vmap(lm_solve)`` over several lanes is lane-dependent on this backend.
The slice as a whole in float32: config 5 (at N=10) through
``make_batched_closed_loop`` with the fused backend (on the CPU the kernel's
plain version answers) against the JAX closed loop with its fused backend,
unbatched per lane (there the per-lane reference stands behind the kernel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.control import PredictiveController as JaxController
from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
from control_box_rst_tpu.models.filters import OneStepPredictor as JaxPredictor
from control_box_rst_tpu.ocp import (
    Bounds as JaxBounds,
    CompositeCost as JaxCompositeCost,
    MinimumTime as JaxMinimumTime,
    QuadraticFinalStateCost as JaxQf,
    finite_differences_grid as jax_fd_grid,
    finite_differences_variable_grid as jax_fd_variable_grid,
    transcribe as jax_transcribe,
)
from control_box_rst_tpu.sim import SimulatedPlant as JaxPlant
from control_box_rst_tpu.sim import run_closed_loop as jax_run_closed_loop
from control_box_rst_tpu.solvers import LMConfig as JaxLMConfig
from control_box_rst_tpu.solvers import QPConfig as JaxQPConfig
from control_box_rst_tpu.solvers import SQPConfig as JaxSQPConfig
from control_box_rst_tpu_torch.control import PredictiveController
from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous, OneStepPredictor
from control_box_rst_tpu_torch.parallel import make_batched_closed_loop
from control_box_rst_tpu_torch.sim import SimulatedPlant, run_closed_loop
from control_box_rst_tpu_torch.solvers import LMConfig, QPConfig, SQPConfig

from torch_port_util import jax_flagship, to_np, torch_ocp_like

torch.set_num_threads(1)
N, T = 10, 15
X0S = np.array([[0.9, -0.2], [-0.6, 0.5], [0.3, 0.8], [-1.0, -0.4]])


def _jax_time_optimal(N):
    """The time-optimal OCP of the C++ golden (one dt tied across the
    intervals, x0 = [1.5, 0] to xf = 0 pinned, |u| <= 1, dt in [1e-3, 0.5])."""
    return jax_transcribe(
        JaxDI(), jax_fd_variable_grid(N, fd_scheme="crank_nicolson"), JaxMinimumTime(),
        bounds=JaxBounds.unbounded(2, 1).with_u(-1.0, 1.0).with_dt(1e-3, 0.5),
        x0=jnp.array([1.5, 0.0]), xf=jnp.zeros(2), xf_fixed=jnp.array([1.0, 1.0]))


RUNS = {
    # name: (JAX OCP, controller dt, SQP settings, initial states, run options)
    "flagship": (lambda: jax_flagship(N, jnp.float64)[0], 0.1,
                 dict(max_iter=10, qp=dict(max_iter=200, tol=1e-10)), X0S, {}),
    "predictor": (lambda: jax_flagship(N, jnp.float64)[0], 0.1,
                  dict(max_iter=10, qp=dict(max_iter=200, tol=1e-10)), X0S,
                  dict(predictor=True)),
    "time_optimal_substeps": (
        lambda: _jax_time_optimal(N), 0.15,
        dict(max_iter=20, qp=dict(max_iter=200, tol=1e-10), tol_stat=1e-6, tol_feas=1e-8),
        np.array([[1.3, 0.0], [1.6, 0.0], [1.8, 0.0], [2.0, 0.0]]),
        dict(apply_sequence_substeps=8)),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_run_closed_loop_matches_jax(run):
    make, dt0, settings, x0s, opts = RUNS[run]
    jocp = make()
    qp = settings["qp"]
    rest = {k: v for k, v in settings.items() if k != "qp"}
    jctrl = JaxController(nx=2, nu=1, ocp=jocp, dt=dt0,
                          cfg=JaxSQPConfig(qp=JaxQPConfig(**qp), **rest))
    ctrl = PredictiveController(nx=2, nu=1, ocp=torch_ocp_like(jocp, "float64"), dt=dt0,
                                cfg=SQPConfig(qp=QPConfig(**qp), **rest),
                                device="cpu", dtype=torch.float64)
    jopts, topts = dict(opts), dict(opts)
    if opts.get("predictor"):
        jopts["predictor"] = JaxPredictor(system=JaxDI())
        topts["predictor"] = OneStepPredictor(system=DoubleIntegratorContinuous())
    jplant, plant = JaxPlant(system=JaxDI()), SimulatedPlant(system=DoubleIntegratorContinuous())
    want = jax.jit(jax.vmap(
        lambda x: jax_run_closed_loop(jplant, jctrl, x, T_steps=T, dt=0.1, **jopts)))(x0s)
    got = run_closed_loop(plant, ctrl, torch.as_tensor(x0s), T, 0.1, **topts)
    for name in ("ts", "x_true", "y", "x_observed", "u", "ok"):
        np.testing.assert_allclose(to_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert set(got.info) == set(want.info)
    for name, v in want.info.items():
        np.testing.assert_allclose(to_np(got.info[name]), np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=name)
    if run == "time_optimal_substeps":
        # the plans' dt (shorter than the sampling time) moved off the guess
        assert float((got.info["dts"] - 0.15).abs().max()) > 1e-2
    else:
        assert bool(got.ok.all())


def test_lm_controller_matches_jax():
    """The closed loop of the JAX package's LM controller test (N=15,
    Crank–Nicolson, LSQ cost, |u| <= 1, LMConfig(max_iter=30),
    usable_feas_tol 1e-2, 100 steps from [1, 0]) and a second lane, float64:
    the port's batch against one JAX call per lane, x_true and u to 1e-6;
    and the JAX test's own asserts."""
    from control_box_rst_tpu.ocp import Bounds, QuadraticFormCost

    N_lm, T_lm = 15, 100
    cost = JaxCompositeCost(costs=(
        QuadraticFormCost(Q=jnp.eye(2), R=0.1 * jnp.eye(1), lsq_form=True),
        JaxQf(Qf=10.0 * jnp.eye(2))))
    jocp = jax_transcribe(JaxDI(), jax_fd_grid(N_lm), cost,
                          bounds=Bounds.unbounded(2, 1).with_u(-1.0, 1.0), x0=jnp.zeros(2))
    jctrl = JaxController(nx=2, nu=1, ocp=jocp, dt=0.1, solver="lm",
                          lm_cfg=JaxLMConfig(max_iter=30), usable_feas_tol=1e-2)
    ctrl = PredictiveController(nx=2, nu=1, ocp=torch_ocp_like(jocp, "float64"), dt=0.1,
                                solver="lm", lm_cfg=LMConfig(max_iter=30), usable_feas_tol=1e-2,
                                device="cpu", dtype=torch.float64)
    x0s = np.array([[1.0, 0.0], [-0.5, 0.3]])
    jplant = JaxPlant(system=JaxDI())
    one = jax.jit(jax.vmap(
        lambda x: jax_run_closed_loop(jplant, jctrl, x, T_steps=T_lm, dt=0.1)))
    want = [one(x0s[i:i + 1]) for i in range(len(x0s))]
    got = run_closed_loop(SimulatedPlant(system=DoubleIntegratorContinuous()), ctrl,
                          torch.as_tensor(x0s), T_lm, 0.1)
    for i, w in enumerate(want):
        for name in ("x_true", "u", "ok"):
            np.testing.assert_allclose(to_np(getattr(got, name)[i]), np.asarray(getattr(w, name))[0],
                                       rtol=0, atol=1e-6, err_msg=f"lane {i} {name}")
        np.testing.assert_array_equal(to_np(got.info["sqp_iters"][i]),
                                      np.asarray(w.info["sqp_iters"])[0])
    assert float(got.x_true[0, -1].abs().max()) < 1e-3
    assert float(got.u.abs().max()) <= 1.0 + 1e-4


def test_config_5_float32_fused_matches_jax():
    """Config 5 at N=10, 4 rollouts of 8 steps, float32, fused backend:
    ``make_batched_closed_loop(device="cpu")`` against the JAX closed loop
    per lane under ``jax.jit`` with x64 off. Float32 tolerances as for the
    config-1 solve (U atol 2e-4); the SQP iterations of a step within one."""
    T5 = 8
    x0s = np.random.default_rng(0).uniform(-1, 1, (4, 2)).astype(np.float32)
    with jax.enable_x64(False):
        jocp, jcfg = jax_flagship(N, jnp.float32)
        jcfg = jcfg.replace(qp=jcfg.qp.replace(backend="fused"))
        jctrl = JaxController(nx=2, nu=1, ocp=jocp, dt=0.1, cfg=jcfg)
        jplant = JaxPlant(system=JaxDI())
        run = jax.jit(lambda x: jax_run_closed_loop(jplant, jctrl, x, T_steps=T5, dt=0.1))
        want = [run(jnp.asarray(x)) for x in x0s]
    from control_box_rst_tpu_torch import entry

    ocp, cfg = entry.flagship(N, device="cpu")
    ctrl = PredictiveController(nx=2, nu=1, ocp=ocp, dt=0.1, device="cpu",
                                cfg=cfg.replace(qp=cfg.qp.replace(backend="fused")))
    got = make_batched_closed_loop(ctrl, SimulatedPlant(system=DoubleIntegratorContinuous()),
                                   T5, 0.1, device="cpu")(x0s)
    assert got.u.dtype == torch.float32
    for i, w in enumerate(want):
        np.testing.assert_allclose(to_np(got.u[i]), np.asarray(w.u), rtol=0, atol=2e-4)
        np.testing.assert_allclose(to_np(got.x_true[i]), np.asarray(w.x_true), rtol=0, atol=2e-4)
        assert to_np(got.ok[i]).all() and np.asarray(w.ok).all()
        d_it = np.abs(to_np(got.info["sqp_iters"][i]) - np.asarray(w.info["sqp_iters"]))
        assert d_it.max() <= 1
