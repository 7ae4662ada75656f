"""PyTorch port vs JAX package: the LQR family — ``control/classic.py``,
``control/dual_mode.py``, ``sim/observer.py:SteadyStateKalmanObserver`` and
the closed loop of ``examples/config5_kalman_dual_mode.yaml``, in float64.

- LQR (K from the CARE at construction, 1e-9), PID over five steps with its
  carry, the simple state controller in both forms and the step response:
  the port's controllers on a batch of states against the JAX ones under
  ``jax.vmap`` (1e-12; the LQR's u 1e-9), the JAX objects handed over by
  ``convert`` as numpy (``lqr_from_numpy``, ``pid_from_numpy``, …).
- The Kalman observer of the config-5 YAML (first-state output, V = 4e-4,
  ZOH discretization by the matrix exponential): Ad, Bd, C, L against the
  JAX package's own config loader (1e-10), L against scipy's filter DARE
  (1e-12); five observe steps on the loader's matrices (1e-12).
- The dual-mode closed loop of the config-5 YAML (N = 10, T = 25, three
  lanes, SQP in float64) with the output noise off, against the JAX run
  (``jax.jit(jax.vmap(run_closed_loop))`` with the loader's controller,
  plant and observer): x_true, x_observed, u, ok, local_active (1e-6).
- A JAX dual-mode carry after two steps (three lanes, one latched inside
  the ball) handed over by ``convert.dual_mode_carry_from_numpy``: the
  port's next step as the JAX next step (1e-6).
- The switch contract on the port's own runs (noise on, from a seeded
  ``torch.Generator``): ``local_active`` = (x̂ᵀ S x̂ ≤ γ), or latched once
  entered; ``make_batched_closed_loop`` takes the dual-mode controller and
  the observer (float32, the fused backend's plain version on the CPU).
"""
import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
import yaml

from control_box_rst_tpu.control import (
    LqrController as JLqr,
    PidController as JPid,
    SimpleStateController as JSimple,
    StepResponseGenerator as JStep,
)
from control_box_rst_tpu.core import config as jconfig
from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
from control_box_rst_tpu.sim import run_closed_loop as jax_run_closed_loop
from control_box_rst_tpu_torch import convert, entry
from control_box_rst_tpu_torch.control import (
    DualModeController,
    LqrController,
    PredictiveController,
    SimpleStateController,
    StepResponseGenerator,
)
from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
from control_box_rst_tpu_torch.parallel import make_batched_closed_loop
from control_box_rst_tpu_torch.sim import (
    GaussianNoise,
    SimulatedPlant,
    SteadyStateKalmanObserver,
    run_closed_loop,
)
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

from torch_port_util import to_np, torch_ocp_like

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)
X = np.array([[0.9, -0.2], [-0.6, 0.5], [0.3, 0.8], [-1.0, -0.4]])
N_CL, T_CL = 10, 25
X0_CL = np.array([[1.0, 0.0], [-0.7, 0.4], [0.5, -0.6]])
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _yaml(n=N_CL, noise=False):
    cfg = yaml.safe_load((EXAMPLES / "config5_kalman_dual_mode.yaml").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["grid"]["N"] = n
    if not noise:
        cfg["plant"]["noise"] = {}
    return cfg


def _step_both(jctrl, tctrl, carry_j, carry_t, xs, t, dt):
    out_j = jax.jit(jax.vmap(lambda c, x: jctrl.step(c, x, t, dt)))(carry_j, jnp.asarray(xs))
    out_t = tctrl.step(carry_t, torch.as_tensor(xs), t, dt)
    return out_j, out_t


def test_lqr_matches_jax():
    Q, R = np.diag([1.0, 2.0]), np.array([[0.5]])
    xref, uref = np.array([0.1, 0.0]), np.array([0.0])
    jl = JLqr.from_system(JaxDI(), jnp.asarray(Q), jnp.asarray(R), xref=jnp.asarray(xref),
                          uref=jnp.asarray(uref))
    tl = LqrController.from_system(DoubleIntegratorContinuous(), Q, R, xref=xref, uref=uref,
                                   **CPU64)
    np.testing.assert_allclose(to_np(tl.K), np.asarray(jl.K), rtol=0, atol=1e-9)
    (_, out_j), (_, out_t) = _step_both(jl, tl, jnp.zeros((4, 0)), (), X, 0.0, 0.1)
    np.testing.assert_allclose(to_np(out_t.u), np.asarray(out_j.u), rtol=0, atol=1e-9)
    # the same gain handed over: the same step to rounding
    th = convert.lqr_from_numpy(dict(K=np.asarray(jl.K), xref=xref, uref=uref), **CPU64)
    _, out_h = th.step((), torch.as_tensor(X), 0.0, 0.1)
    np.testing.assert_allclose(to_np(out_h.u), np.asarray(out_j.u), rtol=0, atol=1e-12)
    assert out_h.u_seq.shape == (4, 1, 1) and out_h.x_seq.shape == (4, 2, 2)
    assert bool(out_h.ok.all())


def test_pid_matches_jax_over_steps():
    spec = dict(nx=2, nu=1, p_gain=1.5, i_gain=0.4, d_gain=0.2, xref=np.array([0.3, -0.1]))
    jp = JPid(nx=2, nu=1, p_gain=1.5, i_gain=0.4, d_gain=0.2, xref=jnp.asarray(spec["xref"]))
    tp = convert.pid_from_numpy(spec, **CPU64)
    cj = jax.vmap(jp.init_carry)(jnp.asarray(X))
    ct = tp.init_carry(torch.as_tensor(X))
    xs = X.copy()
    for k in range(5):
        (cj, oj), (ct, ot) = _step_both(jp, tp, cj, ct, xs, 0.1 * k, 0.1)
        np.testing.assert_allclose(to_np(ot.u), np.asarray(oj.u), rtol=0, atol=1e-12)
        for name in ("p_error", "i_error"):
            np.testing.assert_allclose(to_np(getattr(ct, name)), np.asarray(getattr(cj, name)),
                                       rtol=0, atol=1e-12)
        xs = xs + 0.1 * np.asarray(oj.u)  # move the states between steps
    # a carry handed over from the JAX side continues the same way
    ch = convert.pid_carry_from_numpy(dict(p_error=np.asarray(cj.p_error),
                                           i_error=np.asarray(cj.i_error)), **CPU64)
    (_, oj), (_, oh) = _step_both(jp, tp, cj, ch, xs, 0.5, 0.1)
    np.testing.assert_allclose(to_np(oh.u), np.asarray(oj.u), rtol=0, atol=1e-12)


@pytest.mark.parametrize("form", ["feedback", "prefilter", "step_before", "step_after"])
def test_static_controllers_match_jax(form):
    K, V = np.array([[1.2, 0.7]]), np.array([[0.5, 0.1]])
    xref, uref = np.array([0.2, -0.3]), np.array([0.05])
    t64 = lambda a: torch.as_tensor(a)
    if form == "feedback":
        jc = JSimple(nx=2, nu=1, K=jnp.asarray(K), xref=jnp.asarray(xref), uref=jnp.asarray(uref))
        tc = SimpleStateController(nx=2, nu=1, K=t64(K), xref=t64(xref), uref=t64(uref))
        t = 0.0
    elif form == "prefilter":
        jc = JSimple(nx=2, nu=1, K=jnp.asarray(K), V=jnp.asarray(V), xref=jnp.asarray(xref))
        tc = SimpleStateController(nx=2, nu=1, K=t64(K), V=t64(V), xref=t64(xref))
        t = 0.0
    else:
        u_step, u_init = np.array([0.8]), np.array([-0.2])
        jc = JStep(nx=2, nu=1, u_step=jnp.asarray(u_step), u_init=jnp.asarray(u_init), t_step=0.3)
        tc = StepResponseGenerator(nx=2, nu=1, u_step=t64(u_step), u_init=t64(u_init), t_step=0.3)
        t = 0.2 if form == "step_before" else 0.3
    (_, oj), (_, ot) = _step_both(jc, tc, jnp.zeros((4, 0)), (), X, t, 0.1)
    np.testing.assert_allclose(to_np(ot.u), np.asarray(oj.u), rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_np(ot.x_seq), np.asarray(oj.x_seq), rtol=0, atol=0)


def test_kalman_observer_matches_the_jax_loader():
    cfg = _yaml()
    jplant = jconfig.build_plant(cfg, JaxDI())
    jobs = jconfig.build_observer(cfg, jplant)
    tplant = SimulatedPlant(system=DoubleIntegratorContinuous(), output_kind="first")
    tobs = SteadyStateKalmanObserver.from_plant(tplant, 0.1, V=[[4e-4]], **CPU64)
    for name in ("Ad", "Bd", "C"):
        np.testing.assert_allclose(to_np(getattr(tobs, name)), np.asarray(getattr(jobs, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    # L: the filter DARE's gain, against scipy's and the loader's
    Ad, C, V = np.asarray(jobs.Ad), np.asarray(jobs.C), np.array([[4e-4]])
    P = scipy.linalg.solve_discrete_are(Ad.T, C.T, 1e-3 * np.eye(2), V)
    np.testing.assert_allclose(to_np(tobs.L), P @ C.T @ np.linalg.inv(C @ P @ C.T + V),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_np(tobs.L), np.asarray(jobs.L), rtol=0, atol=1e-10)
    th = convert.kalman_from_numpy({k: np.asarray(getattr(jobs, k)) for k in ("Ad", "Bd", "C", "L")},
                                   **CPU64)
    rng = np.random.default_rng(4)
    cj = jax.vmap(jobs.init_carry)(jnp.asarray(X))
    ct = th.init_carry(torch.as_tensor(X))
    for _ in range(5):
        y, u = rng.standard_normal((4, 1)), rng.standard_normal((4, 1))
        cj, xj = jax.jit(jax.vmap(lambda c, a, b: jobs.observe(c, a, b, 0.1)))(
            cj, jnp.asarray(y), jnp.asarray(u))
        ct, xt = th.observe(ct, torch.as_tensor(y), torch.as_tensor(u), 0.1)
        np.testing.assert_allclose(to_np(xt), np.asarray(xj), rtol=0, atol=1e-12)
    ch = convert.kalman_carry_from_numpy(dict(x_hat=np.asarray(cj.x_hat)), **CPU64)
    np.testing.assert_array_equal(to_np(ch.x_hat), np.asarray(cj.x_hat))


def _port_dual_mode(jdual, latch=True, dtype=torch.float64):
    """The port's dual-mode controller on the JAX loader's OCP and settings."""
    jmpc = jdual.global_controller
    c = jmpc.cfg
    mpc = PredictiveController(
        nx=2, nu=1, ocp=torch_ocp_like(jmpc.ocp, "float64"), dt=0.1,
        cfg=SQPConfig(max_iter=c.max_iter, tol_stat=c.tol_stat, tol_feas=c.tol_feas,
                      qp=QPConfig(max_iter=c.qp.max_iter, tol=c.qp.tol, backend="plain")),
        device="cpu", dtype=dtype)
    local = LqrController.from_system(DoubleIntegratorContinuous(), np.eye(2), np.eye(1),
                                      device="cpu", dtype=dtype)
    return DualModeController(nx=2, nu=1, global_controller=mpc, local_controller=local,
                              S=torch.eye(2, dtype=dtype), gamma=0.09,
                              xf=torch.zeros(2, dtype=dtype), latch=latch)


def _assert_switch_contract(res, latch):
    inside = to_np((res.x_observed ** 2).sum(-1) <= 0.09)
    want = np.maximum.accumulate(inside, axis=1) if latch else inside
    np.testing.assert_array_equal(to_np(res.info["local_active"]), want)


def test_kalman_dual_mode_closed_loop_matches_jax_without_noise():
    cfg = _yaml()
    jdual, jsys = jconfig.build_controller(cfg)
    jplant = jconfig.build_plant(cfg, jsys)
    jobs = jconfig.build_observer(cfg, jplant)
    assert jdual.latch and jplant.output_noise is None
    want = jax.jit(jax.vmap(lambda x: jax_run_closed_loop(
        jplant, jdual, x, T_steps=T_CL, dt=0.1, observer=jobs)))(jnp.asarray(X0_CL))
    dual = _port_dual_mode(jdual)
    plant = SimulatedPlant(system=DoubleIntegratorContinuous(), output_kind="first")
    obs = SteadyStateKalmanObserver.from_plant(plant, 0.1, V=[[4e-4]], **CPU64)
    got = run_closed_loop(plant, dual, torch.as_tensor(X0_CL), T_CL, 0.1, observer=obs)
    for name in ("x_true", "y", "x_observed", "u", "ok"):
        np.testing.assert_allclose(to_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(to_np(got.info["local_active"]),
                                  np.asarray(want.info["local_active"]))
    la = to_np(got.info["local_active"])
    assert not la[:, 0].any() and la[:, -1].all()
    _assert_switch_contract(got, latch=True)


@pytest.mark.parametrize("latch", [True, False])
def test_switch_contract_with_noise(latch):
    """Noise on (a seeded generator): the switch follows the observed state."""
    jdual, _ = jconfig.build_controller(_yaml())
    dual = _port_dual_mode(jdual, latch=latch)
    plant = SimulatedPlant(system=DoubleIntegratorContinuous(), output_kind="first",
                           output_noise=GaussianNoise(std=0.02))
    obs = SteadyStateKalmanObserver.from_plant(plant, 0.1, V=[[4e-4]], **CPU64)
    gen = torch.Generator()
    gen.manual_seed(9)
    res = run_closed_loop(plant, dual, torch.as_tensor(X0_CL), T_CL, 0.1, observer=obs,
                          generator=gen)
    _assert_switch_contract(res, latch)
    assert bool(torch.isfinite(res.u).all())
    assert float((res.y[..., 0] - res.x_true[:, :-1, 0]).abs().max()) > 1e-3  # noisy


def test_batched_kalman_dual_mode_entry_float32():
    """``entry.kalman_dual_mode`` through ``make_batched_closed_loop`` in
    float32 (N = 10 for time; on the CPU 'fused' is the kernel's plain
    version): every lane reaches the LQR, the contract holds, u is finite,
    the generator's noise reaches the plant output."""
    ctrl, plant, T, dt, obs = entry.kalman_dual_mode(N=10, device="cpu")
    mpc = ctrl.global_controller
    ctrl = ctrl.replace(global_controller=mpc.replace(
        cfg=mpc.cfg.replace(qp=mpc.cfg.qp.replace(backend="fused"))))
    roll = make_batched_closed_loop(ctrl, plant, 30, dt, device="cpu", observer=obs)
    gen = torch.Generator()
    gen.manual_seed(1)
    res = roll(X0_CL.astype(np.float32), generator=gen)
    assert res.u.dtype == torch.float32 and bool(torch.isfinite(res.u).all())
    _assert_switch_contract(res, latch=True)
    assert bool(res.info["local_active"][:, -1].all())
    assert T == 60 and obs.L.dtype == torch.float32


def test_dual_mode_carry_handed_over_from_jax():
    """Two JAX dual-mode steps of three lanes (one already inside the ball),
    their carry handed to the port (``convert.dual_mode_carry_from_numpy``):
    the port's next step gives the JAX next step's u, switch and plan (1e-6)."""
    cfg = _yaml()
    jdual, _ = jconfig.build_controller(cfg)
    xs = np.array([[1.0, 0.0], [0.2, -0.1], [-0.6, 0.3]])
    step = jax.jit(jax.vmap(lambda c, x: jdual.step(c, x, 0.0, 0.1)))
    cj = jax.vmap(jdual.init_carry)(jnp.asarray(xs))
    for _ in range(2):
        cj, oj = step(cj, jnp.asarray(xs))
        xs = xs + 0.1 * np.stack([xs[:, 1], np.asarray(oj.u)[:, 0]], axis=1)
    cj_next, oj_next = step(cj, jnp.asarray(xs))
    mc = cj.mpc_carry
    ct = convert.dual_mode_carry_from_numpy(dict(
        mpc_carry={k: np.asarray(getattr(mc, k)) for k in mc._fields},
        local_carry=None, local_active=np.asarray(cj.local_active)), **CPU64)
    dual = _port_dual_mode(jdual)
    ct_next, ot = dual.step(ct, torch.as_tensor(xs), 0.0, 0.1)
    np.testing.assert_array_equal(to_np(ct_next.local_active), np.asarray(cj_next.local_active))
    assert bool(ct_next.local_active[1]) and not bool(ct_next.local_active[0])
    for name in ("u", "u_seq", "x_seq"):
        np.testing.assert_allclose(to_np(getattr(ot, name)), np.asarray(getattr(oj_next, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
