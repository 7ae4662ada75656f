"""The port's adaptive and multi-stage integrators (``ops/integrators.py``)
against the JAX package's, float64 on the CPU.

- ``AdaptiveStepIntegrator`` (Dormand-Prince 5(4), a fixed budget of
  substeps, accept / reject per lane) on Van der Pol and the Duffing
  oscillator, 8 lanes of seeded states, controls and interval lengths at
  two tolerances: the state after dt within 1e-10, and which substeps each
  lane accepted. Every lane reaches dt inside the budget: a lane that runs
  out of it stops at a time that hangs on the rounding of its step-size
  updates (err near the rounding level makes (tol/err)^(1/5) sensitive to
  the last bits), so its state is not a port-against-reference quantity. The reference returns the state only, so its accepted
  substeps are read off its runs with budgets 1, 2, …, S: substep k was
  accepted where the state after k substeps differs from the state after
  k − 1 (a rejected or finished substep leaves the state as it was).
- ``MultiStageFixedStep`` and ``MultiStageScaled`` over RK4 and RK2, within
  1e-10.
- The factory's "integrator" registrations make the same integrators as
  ``make_integrator``; the adaptive and multi-stage integrators are made
  directly, not by name, in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.models import DuffingOscillator as JDuffing
from control_box_rst_tpu.models import VanDerPolOscillator as JVdP
from control_box_rst_tpu.ops import integrators as ji

from control_box_rst_tpu_torch.core.factory import Factory
from control_box_rst_tpu_torch.models import DuffingOscillator, VanDerPolOscillator
from control_box_rst_tpu_torch.ops import integrators as ti

TOL = 1e-10
LANES = 8
BUDGET = 16
SYSTEMS = {
    "van_der_pol": (JVdP(a=1.5), VanDerPolOscillator(a=1.5)),
    "duffing": (JDuffing(damping=0.2, spring_alpha=-1.0, spring_beta=1.0),
                DuffingOscillator(damping=0.2, spring_alpha=-1.0, spring_beta=1.0)),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, size=(LANES, 2))
    u = rng.uniform(-1.0, 1.0, size=(LANES, 1))
    dt = rng.uniform(0.05, 0.3, size=LANES)
    return x, u, dt


@pytest.mark.parametrize("abs_tol", [1e-6, 1e-9])
@pytest.mark.parametrize("system", list(SYSTEMS))
def test_adaptive_step_matches_jax(system, abs_tol):
    jsys, tsys = SYSTEMS[system]
    x, u, dt = _inputs(int(abs_tol < 1e-7))
    tint = ti.AdaptiveStepIntegrator(abs_tol=abs_tol, max_substeps=BUDGET)
    xf, accepted = tint.solve_ivp_accepted(
        tsys, torch.as_tensor(x), torch.as_tensor(u), torch.as_tensor(dt))
    states = []
    for k in range(BUDGET + 1):
        jint = ji.AdaptiveStepIntegrator(abs_tol=abs_tol, max_substeps=k)
        run = jax.jit(jax.vmap(lambda xx, uu, dd, j=jint: j.solve_ivp(jsys, xx, uu, dd)))
        states.append(np.asarray(run(jnp.asarray(x), jnp.asarray(u), jnp.asarray(dt))))
    # every lane finished inside the budget (its last substeps change nothing)
    assert (states[-1] == states[-2]).all()
    np.testing.assert_allclose(xf.numpy(), states[-1], rtol=0, atol=TOL)
    want_accepted = np.stack(
        [np.any(states[k + 1] != states[k], axis=-1) for k in range(BUDGET)], axis=-1)
    np.testing.assert_array_equal(accepted.numpy(), want_accepted)
    # the budget is used: some substeps rejected, every lane accepted some
    assert want_accepted.any(axis=-1).all()
    if abs_tol < 1e-7:
        assert not want_accepted.all()


def test_adaptive_step_scalar_dt_and_one_lane():
    """A Python-number dt and an unbatched state, as the reference takes them."""
    jsys, tsys = SYSTEMS["van_der_pol"]
    x, u = np.array([1.0, -0.5]), np.array([0.3])
    want = ji.AdaptiveStepIntegrator(abs_tol=1e-8, max_substeps=16).solve_ivp(
        jsys, jnp.asarray(x), jnp.asarray(u), 0.4)
    got = ti.AdaptiveStepIntegrator(abs_tol=1e-8, max_substeps=16).solve_ivp(
        tsys, torch.as_tensor(x), torch.as_tensor(u), 0.4)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("inner", ["rk4", "rk2"])
def test_multi_stage_match_jax(inner):
    jsys, tsys = SYSTEMS["duffing"]
    x, u, dt = _inputs(3)
    pairs = [
        (ji.MultiStageFixedStep(inner=ji.make_integrator(inner), n=7),
         ti.MultiStageFixedStep(inner=ti.make_integrator(inner), n=7)),
        (ji.MultiStageScaled(inner=ji.make_integrator(inner), dt_ref=0.05, n_max=5),
         ti.MultiStageScaled(inner=ti.make_integrator(inner), dt_ref=0.05, n_max=5)),
    ]
    for jint, tint in pairs:
        want = jax.jit(jax.vmap(lambda xx, uu, dd, j=jint: j.solve_ivp(jsys, xx, uu, dd)))(
            jnp.asarray(x), jnp.asarray(u), jnp.asarray(dt))
        got = tint.solve_ivp(tsys, torch.as_tensor(x), torch.as_tensor(u), torch.as_tensor(dt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_integrator_registrations():
    import control_box_rst_tpu.ops.integrators  # noqa: F401 (registers)
    from control_box_rst_tpu.core.factory import Factory as JaxFactory

    names = list(Factory.names("integrator"))
    assert names == list(JaxFactory.names("integrator"))
    for name in names:
        made = Factory.create("integrator", name, num_substeps=3)
        want = ti.make_integrator(name, 3)
        assert (made.name, made.order, made.num_substeps) == (want.name, want.order, 3)
    for name in ("adaptive_step", "multi_stage_fixed_step", "multi_stage_scaled"):
        with pytest.raises(KeyError):
            ti.make_integrator(name)
        with pytest.raises(KeyError):
            ji.make_integrator(name)
