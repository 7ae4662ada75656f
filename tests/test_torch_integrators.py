"""PyTorch port vs JAX package: the explicit integrators and the Van der Pol
model, float64, atol 1e-12 (rtol 1e-12 on values of order one: the same
tableau coefficients in the same order on both sides, so the two differ by
rounding only).

Every tableau (Euler, RK2 … RK7) steps the Van der Pol oscillator
(config 2's model) from a few states and controls from a seed: ``step``,
``solve_ivp`` with 1 and 3 substeps and ``solve_ivp_traj``; the port takes a
batch of states in one call, and every lane must equal the JAX function's
unbatched answer. Every JAX call goes through ``jax.jit`` (see the note in
tests/test_torch_ops.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.models import VanDerPolOscillator as JaxVdP
from control_box_rst_tpu.ops.integrators import make_integrator as jax_make_integrator
from control_box_rst_tpu_torch.models import VanDerPolOscillator
from control_box_rst_tpu_torch.ops.integrators import make_integrator

from torch_port_util import to_np

torch.set_num_threads(1)
TOL = 1e-12
NAMES = ["euler", "rk2", "rk3", "rk4", "rk5", "rk6", "rk7"]


def _inputs(seed=0, B=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (B, 2))
    u = rng.uniform(-1.0, 1.0, (B, 1))
    dt = rng.uniform(0.05, 0.3, (B,))
    return x, u, dt


def _cmp(got, want):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_van_der_pol_matches_jax():
    x, u, _ = _inputs(1)
    for a in (1.0, 0.4):
        f_j = np.asarray(jax.jit(jax.vmap(JaxVdP(a=a)))(jnp.asarray(x), jnp.asarray(u)))
        f_t = VanDerPolOscillator(a=a)
        _cmp(f_t(torch.from_numpy(x), torch.from_numpy(u)), f_j)
        assert not f_t.is_linear and f_t.continuous_time and (f_t.nx, f_t.nu) == (2, 1)
        A, B = f_t.linearize(torch.from_numpy(x[0]), torch.from_numpy(u[0]))
        A_j, B_j = jax.jit(JaxVdP(a=a).linearize)(jnp.asarray(x[0]), jnp.asarray(u[0]))
        _cmp(A, A_j)
        _cmp(B, B_j)


@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_explicit_integrators_match_jax(name, substeps):
    x, u, dt = _inputs()
    f_j, f_t = JaxVdP(), VanDerPolOscillator()
    integ_j = jax_make_integrator(name, substeps)
    integ_t = make_integrator(name, substeps)
    assert (integ_t.order, integ_t.num_substeps, integ_t.name) == (
        integ_j.order, integ_j.num_substeps, integ_j.name)
    xt, ut, dtt = (torch.from_numpy(a) for a in (x, u, dt))
    step_t = integ_t.step(f_t, xt, ut, dtt)
    ivp_t = integ_t.solve_ivp(f_t, xt, ut, dtt)
    traj_t = integ_t.solve_ivp_traj(f_t, xt, ut, dtt)
    assert traj_t.shape == (len(x), substeps + 1, 2)
    step_j = jax.jit(lambda a, b, h: integ_j.step(f_j, a, b, h))
    ivp_j = jax.jit(lambda a, b, h: integ_j.solve_ivp(f_j, a, b, h))
    traj_j = jax.jit(lambda a, b, h: integ_j.solve_ivp_traj(f_j, a, b, h))
    for i in range(len(x)):
        args = (jnp.asarray(x[i]), jnp.asarray(u[i]), jnp.asarray(dt[i]))
        _cmp(step_t[i], step_j(*args))
        _cmp(ivp_t[i], ivp_j(*args))
        _cmp(traj_t[i], traj_j(*args))
    # a Python number as dt, unbatched state
    _cmp(integ_t.solve_ivp(f_t, xt[0], ut[0], 0.1),
         ivp_j(jnp.asarray(x[0]), jnp.asarray(u[0]), 0.1))


def test_integrators_converge_at_their_order():
    """The port's own tableaux, independent of the reference: halving the
    step divides the one-step error of order p by about 2^(p+1)."""
    f = VanDerPolOscillator()
    x = torch.tensor([0.7, -0.4], dtype=torch.float64)
    u = torch.tensor([0.3], dtype=torch.float64)
    exact = make_integrator("rk7", 64).solve_ivp(f, x, u, 0.2)
    for name in NAMES[:5]:
        integ = make_integrator(name)
        e1 = float((integ.solve_ivp(f, x, u, 0.2) - exact).abs().max())
        e2 = float((integ.solve_ivp(f, x, u, 0.1) - make_integrator("rk7", 32).solve_ivp(
            f, x, u, 0.1)).abs().max())
        rate = np.log2(e1 / e2)
        assert rate > integ.order + 0.5, (name, rate)


def test_unported_integrators_are_refused():
    for name in ("adaptive_step", "multi_stage_fixed_step", "multi_stage_scaled"):
        with pytest.raises(NotImplementedError):
            make_integrator(name)
    with pytest.raises(KeyError):
        make_integrator("no_such_integrator")
