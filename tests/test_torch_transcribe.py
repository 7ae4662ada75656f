"""PyTorch port vs JAX package: model, problem containers and transcription
on the config-1 OCP at N=8, float64, tolerance 1e-10 (the same formulas on
both sides; derivatives are exact AD on both, so they differ by rounding).

A second OCP variant (integral cost, trapezoidal integration, a masked tail
interval) covers the branches config 1 itself does not take. The nonlinear
configurations add four: config 2 (Van der Pol, multiple shooting, RK4),
config 3 (the time-optimal grid with its dt tie rows, ``MinimumTime``) and
its least-squares form, and multiple shooting with a tied dt (RK4 with three
substeps: the two mechanisms composed). Every JAX call goes through
``jax.jit`` (see the note in tests/test_torch_ops.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
from control_box_rst_tpu.ocp.problem import Trajectory as JaxTrajectory
from control_box_rst_tpu_torch import convert
from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous as TorchDI
from control_box_rst_tpu_torch.ocp.problem import Trajectory as TorchTrajectory

from torch_port_util import (
    jax_flagship,
    jax_time_optimal,
    jax_vdp_ms,
    spec_from_jax_ocp,
    to_np,
)

torch.set_num_threads(1)
TOL = 1e-10
N = 8
VARIANTS = ["config1", "trapezoidal_masked", "vdp_ms", "time_optimal",
            "time_optimal_lsq", "vdp_ms_variable_dt"]
# variants whose interval Jacobians and cost Hessian are constant in W
LTI = {"config1", "trapezoidal_masked"}


def _jax_nonlinear(variant):
    if variant == "vdp_ms":
        return jax_vdp_ms(N, jnp.float64)[0]
    if variant == "time_optimal":
        return jax_time_optimal(N, jnp.float64)[0]
    if variant == "time_optimal_lsq":
        ocp_j = jax_time_optimal(N, jnp.float64)[0]
        return ocp_j.replace(cost=ocp_j.cost.replace(lsq_form=True, weight=2.5))
    from control_box_rst_tpu.ocp import multiple_shooting_variable_grid

    ocp_j = jax_vdp_ms(N, jnp.float64)[0]
    return ocp_j.replace(
        grid=multiple_shooting_variable_grid(N, "rk4", 3),
        bounds=ocp_j.bounds.with_dt(0.05, 0.2),
    )


def _ocps(variant):
    if variant == "config1":
        ocp_j, _ = jax_flagship(N, jnp.float64)
    elif variant != "trapezoidal_masked":
        ocp_j = _jax_nonlinear(variant)
    else:
        ocp_j, _ = jax_flagship(
            N, jnp.float64, cost_integration="trapezoidal", integral=True
        )
        mask = np.ones(N)
        mask[-2:] = 0.0
        ocp_j = ocp_j.replace(stage_mask=jnp.asarray(mask))
    x0 = np.array([0.8, -0.3])
    ocp_j = ocp_j.replace(bc=ocp_j.bc.replace(x0=jnp.asarray(x0)))
    ocp_t = convert.ocp_from_numpy(spec_from_jax_ocp(ocp_j), dtype=torch.float64, device="cpu")
    return ocp_j, ocp_t


def _random_W(seed=0, variant="config1"):
    """A stage matrix from a seed; for the nonlinear variants dt varies from
    stage to stage (0.08 to 0.12), so the tie rows of a tied-dt grid are not
    zero."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((N + 1, 4)) * 0.5
    W[:, 3] = 0.1 if variant in LTI else rng.uniform(0.08, 0.12, N + 1)
    W[-1, 2:] = 0.0
    return W


def _jax_interp(x0, xf):
    return jax.jit(lambda a, b: JaxTrajectory.linear_interp(a, b, N, 1, 0.1))(
        jnp.asarray(x0), jnp.asarray(xf)
    )


def _cmp(t, j, tol=TOL):
    t, j = to_np(t), np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol)


def test_model_matches_jax():
    rng = np.random.default_rng(1)
    x, u = rng.standard_normal((5, 2)), rng.standard_normal((5, 1))
    f_j = np.asarray(jax.jit(jax.vmap(JaxDI(0.7)))(jnp.asarray(x), jnp.asarray(u)))
    sys_t = TorchDI(0.7)
    _cmp(sys_t(torch.from_numpy(x), torch.from_numpy(u)), f_j)
    assert sys_t.is_linear and sys_t.continuous_time
    A, B = sys_t.linearize(torch.from_numpy(x[0]), torch.from_numpy(u[0]))
    A_j, B_j = jax.jit(JaxDI(0.7).linearize)(jnp.asarray(x[0]), jnp.asarray(u[0]))
    _cmp(A, A_j)
    _cmp(B, B_j)


def test_linear_interp_matches_jax():
    x0, xf = np.array([1.0, -0.5]), np.array([0.2, 0.1])
    tj = _jax_interp(x0, xf)
    tt = TorchTrajectory.linear_interp(
        torch.from_numpy(x0), torch.from_numpy(xf), N, 1, 0.1
    )
    _cmp(tt.X, tj.X)
    _cmp(tt.U, tj.U)
    _cmp(tt.dts, tj.dts)
    # batched x0: X gets the batch, every lane equals its own unbatched call
    x0b = np.stack([x0, 2 * x0, -x0])
    tb = TorchTrajectory.linear_interp(
        torch.from_numpy(x0b), torch.from_numpy(xf), N, 1, 0.1
    )
    assert tb.X.shape == (3, N + 1, 2) and tb.U.shape == (N, 1)
    _cmp(tb.X[0], tj.X)
    _cmp(tb.total_time(), jax.jit(lambda t: t.total_time())(tj))


@pytest.mark.parametrize("variant", VARIANTS)
def test_pack_unpack_apply_boundary(variant):
    ocp_j, ocp_t = _ocps(variant)
    xf = np.zeros(2)
    tj = _jax_interp(np.array([0.3, 0.3]), xf)
    tt = TorchTrajectory.linear_interp(
        torch.tensor([0.3, 0.3], dtype=torch.float64), torch.from_numpy(xf), N, 1, 0.1
    )
    tj, tt = jax.jit(ocp_j.apply_boundary)(tj), ocp_t.apply_boundary(tt)
    _cmp(tt.X, tj.X)
    Wj, Wt = jax.jit(ocp_j.pack)(tj), ocp_t.pack(tt)
    _cmp(Wt, Wj)
    back_j, back_t = jax.jit(ocp_j.unpack)(Wj), ocp_t.unpack(Wt)
    for name in ("X", "U", "dts"):
        _cmp(getattr(back_t, name), getattr(back_j, name))
    assert (ocp_t.N, ocp_t.nx, ocp_t.nu, ocp_t.nz, ocp_t.nc, ocp_t.ng) == (
        ocp_j.N, ocp_j.nx, ocp_j.nu, ocp_j.nz, ocp_j.nc, ocp_j.ng)


@pytest.mark.parametrize("variant", VARIANTS)
def test_interval_residuals_and_jacobians(variant):
    ocp_j, ocp_t = _ocps(variant)
    W = _random_W(0, variant)
    Wj, Wt = jnp.asarray(W), torch.from_numpy(W)
    _cmp(ocp_t.interval_residuals(Wt), jax.jit(ocp_j.interval_residuals)(Wj))
    Jj, Kj, cj = jax.jit(ocp_j.interval_jacobians)(Wj)
    Jt, Kt, ct = ocp_t.interval_jacobians(Wt)
    _cmp(Jt, Jj)
    _cmp(Kt, Kj)
    _cmp(ct, cj)
    _cmp(ocp_t.defects(ocp_t.unpack(Wt)),
         jax.jit(lambda w: ocp_j.defects(ocp_j.unpack(w)))(Wj))


@pytest.mark.parametrize("variant", VARIANTS)
def test_objective_gradient_hessian(variant):
    ocp_j, ocp_t = _ocps(variant)
    W = _random_W(2, variant)
    Wj, Wt = jnp.asarray(W), torch.from_numpy(W)
    _cmp(ocp_t.objective_from_W(Wt), jax.jit(ocp_j.objective_from_W)(Wj))
    _cmp(ocp_t.objective(ocp_t.unpack(Wt)),
         jax.jit(lambda w: ocp_j.objective(ocp_j.unpack(w)))(Wj))
    _cmp(ocp_t.cost_gradient(Wt), jax.jit(ocp_j.cost_gradient)(Wj))
    _cmp(ocp_t.cost_hessian_blocks(Wt), jax.jit(ocp_j.cost_hessian_blocks)(Wj))


@pytest.mark.parametrize("variant", VARIANTS)
def test_batched_W_equals_per_lane(variant):
    """[B, N+1, nz] through every transcription function gives each lane what
    the unbatched call gives it (1e-12: same arithmetic, batch written out)."""
    _, ocp_t = _ocps(variant)
    Ws = torch.from_numpy(np.stack([_random_W(s, variant) for s in (3, 4, 5)]))
    c = ocp_t.interval_residuals(Ws)
    J, K, _ = ocp_t.interval_jacobians(Ws)
    f = ocp_t.objective_from_W(Ws)
    g = ocp_t.cost_gradient(Ws)
    H = ocp_t.cost_hessian_blocks(Ws)
    for i in range(3):
        Ji, Ki, ci = ocp_t.interval_jacobians(Ws[i])
        for got, want in (
            (c[i], ci), (J[i], Ji), (K[i], Ki),
            (f[i], ocp_t.objective_from_W(Ws[i])),
            (g[i], ocp_t.cost_gradient(Ws[i])),
            (H[i], ocp_t.cost_hessian_blocks(Ws[i])),
        ):
            _cmp(got, to_np(want), tol=1e-12)


@pytest.mark.parametrize("variant", VARIANTS)
def test_bounds_pins_and_structure(variant):
    ocp_j, ocp_t = _ocps(variant)
    lb_j, ub_j = jax.jit(ocp_j.w_bounds)()
    lb_t, ub_t = ocp_t.w_bounds()
    np.testing.assert_array_equal(to_np(lb_t), np.asarray(lb_j))
    np.testing.assert_array_equal(to_np(ub_t), np.asarray(ub_j))
    np.testing.assert_array_equal(to_np(ocp_t.fixed_mask()), np.asarray(jax.jit(ocp_j.fixed_mask)()))
    assert ocp_t.lti_structure == ocp_j.lti_structure == (variant in LTI)
    assert ocp_t.constant_hessian == ocp_j.constant_hessian == (variant in LTI)
    W = torch.from_numpy(_random_W(0, variant))
    r, rl, ru = ocp_t.general_rows(W)
    rj, _, _ = jax.jit(ocp_j.general_rows)(jnp.asarray(_random_W(0, variant)))
    assert r.shape == rl.shape == ru.shape == rj.shape == (N + 1, 0)
    assert ocp_t.general_row_jacobians(W).shape == (N + 1, 0, 4)


def test_terminal_pin_mask_and_boundary():
    ocp_j, _ = jax_flagship(N, jnp.float64)
    bc = ocp_j.bc.replace(
        x0=jnp.asarray([0.5, 0.0]), xf=jnp.asarray([0.1, -0.2]),
        xf_fixed=jnp.asarray([1.0, 0.0]),
    )
    ocp_j = ocp_j.replace(bc=bc)
    ocp_t = convert.ocp_from_numpy(spec_from_jax_ocp(ocp_j), dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(to_np(ocp_t.fixed_mask()), np.asarray(jax.jit(ocp_j.fixed_mask)()))
    tj = _jax_interp(np.ones(2), np.ones(2))
    tt = TorchTrajectory.linear_interp(
        torch.ones(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64), N, 1, 0.1
    )
    _cmp(ocp_t.apply_boundary(tt).X, jax.jit(ocp_j.apply_boundary)(tj).X)


def test_unported_structure_is_refused():
    """A name that is reachable but not ported raises; it never computes."""
    from control_box_rst_tpu_torch.ocp.grids import Grid
    from control_box_rst_tpu_torch.ops.collocation import get_fd_collocation

    _, ocp_t = _ocps("config1")
    # a grid names its integrator from make_integrator's tableaux; the
    # adaptive integrator is not one of them, here as in the reference
    with pytest.raises(KeyError):
        ocp_t.replace(grid=Grid(N=N, kind="ms", integrator="adaptive_step"))
    # the other grids are (a move-blocking sequence must name every interval)
    for grid in (Grid(N=N, fd_scheme="backward"), Grid(N=N, u_blocks=tuple(range(N)))):
        assert ocp_t.replace(grid=grid).nc == 2 + (1 if grid.has_u_tie else 0)
    with pytest.raises(ValueError):
        ocp_t.replace(grid=Grid(N=N, u_blocks=(0, 0)))
    with pytest.raises(KeyError):
        get_fd_collocation("no_such_scheme")
    with pytest.raises(ValueError):
        ocp_t.replace(grid=Grid(N=N, dt_mode="no_such_dt_mode"))
