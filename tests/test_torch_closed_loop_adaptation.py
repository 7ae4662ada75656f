"""PyTorch port vs JAX package: the closed loop with grid adaptation.

Short closed loops, float64, the port's batch of lanes against the JAX
package's ``run_closed_loop`` per lane, step by step: the same sequence of
active horizons ``n_active`` (exactly), the same SQP iteration counts and
usable flags, u to 1e-8.

- Config 4 at N = 8 under ``RedundantControls`` (the adaptation of golden
  case 9), ``n_active_init=6``, ``warm_start_shift=False``: one horizon per
  lane, and a lane that is never usable.
- Config 3's single-dt grid at N = 10 under ``TimeBasedSingleStep`` with the
  warm-start shift on and ``n_active_init=8``: the shift honours each lane's
  horizon.
- The LM controller with ``RedundantControls`` on config 4 at N = 6
  (one JAX call per lane: ``jax.vmap(lm_solve)`` is lane-dependent on this
  backend).

The solver settings are config 4's float32 ones (``entry.
nonuniform_ms_timeopt``) on both sides: they converge in few iterations,
which keeps the eager float64 runs of the port short on this CPU. The
case-9 contract over 25 steps is held on the card (``chip_smoke.py``,
phase ``nonuniform``): see tests/test_torch_nonuniform_golden.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from control_box_rst_tpu.control import PredictiveController as JaxController
from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
from control_box_rst_tpu.ocp import (
    Bounds as JaxBounds,
    MinimumTime as JaxMinimumTime,
    non_uniform_multiple_shooting_variable_grid as jax_nu_ms_grid,
    transcribe as jax_transcribe,
)
from control_box_rst_tpu.ocp import adaptation as jad
from control_box_rst_tpu.sim import SimulatedPlant as JaxPlant
from control_box_rst_tpu.sim import run_closed_loop as jax_run_closed_loop
from control_box_rst_tpu.solvers import LMConfig as JaxLMConfig
from control_box_rst_tpu.solvers import QPConfig as JaxQPConfig
from control_box_rst_tpu.solvers import SQPConfig as JaxSQPConfig
from control_box_rst_tpu_torch import convert
from control_box_rst_tpu_torch.control import PredictiveController
from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
from control_box_rst_tpu_torch.sim import SimulatedPlant, run_closed_loop
from control_box_rst_tpu_torch.solvers import LMConfig, QPConfig, SQPConfig

from torch_port_util import jax_time_optimal, to_np, torch_ocp_like

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)
SQP_KW = dict(max_iter=25, tol_stat=3e-4, tol_feas=1e-5)
QP_KW = dict(max_iter=80, iters_per_round=40, tol=1e-5)


def _jax_config4(n):
    return jax_transcribe(
        JaxDI(), jax_nu_ms_grid(n, integrator="rk4", substeps=1),
        JaxMinimumTime(weight=float(n), lsq_form=True),
        bounds=JaxBounds.unbounded(2, 1).with_u(-1.0, 1.0).with_dt(1e-3, 0.5),
        x0=jnp.array([1.5, 0.0]), xf=jnp.zeros(2), xf_fixed=jnp.array([1.0, 1.0]),
    )


def _controllers(ocp_j, kind, fields, **kw):
    """The JAX controller and the port's, with the same adaptation and SQP
    settings (plus ``kw``: the other controller fields, the same on both)."""
    jctrl = JaxController(nx=2, nu=1, ocp=ocp_j, dt=0.1, adaptation=getattr(jad, kind)(**fields),
                          cfg=JaxSQPConfig(qp=JaxQPConfig(**QP_KW), **SQP_KW), **kw)
    ctrl = PredictiveController(
        nx=2, nu=1, ocp=torch_ocp_like(ocp_j, "float64"), dt=0.1,
        adaptation=convert.adaptation_from_numpy(dict(kind=kind, **fields)),
        cfg=SQPConfig(qp=QPConfig(**QP_KW), **SQP_KW), **kw, **CPU64)
    return jctrl, ctrl


def _assert_same_rollouts(got, want, u_tol=1e-8):
    n_got, n_want = to_np(got.info["n_active"]), np.asarray(want.info["n_active"])
    np.testing.assert_array_equal(n_got, n_want)
    np.testing.assert_array_equal(to_np(got.info["sqp_iters"]), np.asarray(want.info["sqp_iters"]))
    np.testing.assert_array_equal(to_np(got.ok), np.asarray(want.ok))
    np.testing.assert_allclose(to_np(got.u), np.asarray(want.u), rtol=0, atol=u_tol)
    np.testing.assert_allclose(to_np(got.x_true), np.asarray(want.x_true), rtol=0, atol=u_tol)
    return n_got


def test_redundant_controls_closed_loop_matches_jax():
    """Config 4, N = 8, RedundantControls(epsilon=1e-3, backup=1, n_min=2),
    n_active_init=6, no shift, 4 steps of 0.1, three lanes (the third,
    [1.2, 0.3], is never usable: its steps apply zero controls)."""
    N, T = 8, 4
    jctrl, ctrl = _controllers(
        _jax_config4(N), "RedundantControls", dict(epsilon=1e-3, backup=1, n_min=2, n_max=N),
        warm_start_shift=False, n_active_init=6)
    x0s = np.array([[1.5, 0.0], [2.0, -0.2], [1.2, 0.3]])
    jplant = JaxPlant(system=JaxDI())
    want = jax.jit(jax.vmap(lambda x: jax_run_closed_loop(jplant, jctrl, x, T_steps=T, dt=0.1)))(
        jnp.asarray(x0s))
    assert ctrl.hoisted == (None, None, None)
    got = run_closed_loop(SimulatedPlant(system=DoubleIntegratorContinuous()), ctrl,
                          torch.as_tensor(x0s), T, 0.1)
    n_active = _assert_same_rollouts(got, want)
    assert n_active.dtype == np.int32 and n_active[:, 0].tolist() == [5, 5, 5]
    # the lanes took different horizons, and the third lane was never usable
    assert len({tuple(r) for r in n_active}) == 3
    assert not bool(got.ok[2].any()) and bool(got.ok[0, :2].all())


def test_time_based_single_step_with_the_shift_matches_jax():
    """Config 3's grid (one dt tied across the intervals, tie rows under the
    per-lane stage mask), N = 10, TimeBasedSingleStep(dt_ref=0.1,
    dt_hyst_ratio=0.2, n_min=4), the warm-start shift on, n_active_init=8,
    5 steps, two lanes."""
    N, T = 10, 5
    ocp_j = jax_time_optimal(N, jnp.float64)[0]
    jctrl, ctrl = _controllers(
        ocp_j, "TimeBasedSingleStep", dict(dt_ref=0.1, dt_hyst_ratio=0.2, n_min=4, n_max=N),
        n_active_init=8)
    x0s = np.array([[1.0, 0.0], [0.4, -0.3]])
    jplant = JaxPlant(system=JaxDI())
    want = jax.jit(jax.vmap(lambda x: jax_run_closed_loop(jplant, jctrl, x, T_steps=T, dt=0.1)))(
        jnp.asarray(x0s))
    got = run_closed_loop(SimulatedPlant(system=DoubleIntegratorContinuous()), ctrl,
                          torch.as_tensor(x0s), T, 0.1)
    n_active = _assert_same_rollouts(got, want)
    assert len({tuple(r) for r in n_active}) == 2


def test_lm_controller_with_adaptation_matches_jax():
    """The LM controller (LMConfig(max_iter=20)) with RedundantControls
    (epsilon=1e-3, n_min=2) on config 4 at N = 6, n_active_init=5, 4 steps,
    two lanes: the port's batch against one JAX call per lane, u to 1e-8."""
    N, T = 6, 4
    ocp_j = _jax_config4(N)
    kw = dict(n_active_init=5, warm_start_shift=False, solver="lm")
    fields = dict(epsilon=1e-3, backup=1, n_min=2, n_max=N)
    jctrl = JaxController(nx=2, nu=1, ocp=ocp_j, dt=0.1, lm_cfg=JaxLMConfig(max_iter=20),
                          adaptation=jad.RedundantControls(**fields), **kw)
    ctrl = PredictiveController(
        nx=2, nu=1, ocp=torch_ocp_like(ocp_j, "float64"), dt=0.1, lm_cfg=LMConfig(max_iter=20),
        adaptation=convert.adaptation_from_numpy(dict(kind="RedundantControls", **fields)),
        **kw, **CPU64)
    x0s = np.array([[1.5, 0.0], [0.7, 0.2]])
    jplant = JaxPlant(system=JaxDI())
    one = jax.jit(jax.vmap(lambda x: jax_run_closed_loop(jplant, jctrl, x, T_steps=T, dt=0.1)))
    want = [one(jnp.asarray(x0s[i:i + 1])) for i in range(len(x0s))]
    got = run_closed_loop(SimulatedPlant(system=DoubleIntegratorContinuous()), ctrl,
                          torch.as_tensor(x0s), T, 0.1)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(to_np(got.info["n_active"][i]),
                                      np.asarray(w.info["n_active"])[0])
        np.testing.assert_array_equal(to_np(got.info["sqp_iters"][i]),
                                      np.asarray(w.info["sqp_iters"])[0])
        np.testing.assert_allclose(to_np(got.u[i]), np.asarray(w.u)[0], rtol=0, atol=1e-8,
                                   err_msg=f"lane {i}")
    # RedundantControls gave the two lanes different horizons
    assert not np.array_equal(to_np(got.info["n_active"][0]), to_np(got.info["n_active"][1]))
