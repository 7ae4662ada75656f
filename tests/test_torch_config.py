"""The port's config loader (``core/config.py``) against the JAX package's,
builder by builder, on every branch, float64 on the CPU.

The same dict goes to both packages' builders:

- ``build_ocp`` on every grid type, every cost type (with the final-state
  and the L1 soft-bound parts) and the three ``constraints:`` forms: the
  transcribed OCPs' shapes (nz, nc, n_aux, n_tie, ng), bounds, fixed mask,
  boundary conditions and, at a seeded stage matrix W, the interval
  residuals and Jacobians, the objective, its gradient, the Hessian blocks
  and the general rows with their bounds, within 1e-10. Config 6's YAML
  (``integral: true``) builds a ``CompositeCost`` whose own ``integral`` is
  False in both packages, as the reference's loader builds it.
- ``build_plant``: the output kinds (full, first, a C matrix), the
  integrator and its substeps, a plant-side system, the noise terms; one
  plant step and output on seeded states (noise off), within 1e-12.
- ``build_observer``: none, and the Kalman filter of the config-5 YAML and
  of a C-matrix plant with W and V given: Ad, Bd, C and the gain L within
  1e-10 (the port discretizes by ``sim/observer.py:zoh_discretize``, on the
  host in float64).
- ``build_controller``: the predictive controller with ``solver: sqp | ip |
  lm`` (the solver settings field by field) and every ``adaptation`` kind
  (its fields); the LQR, PID, state-feedback, step-response and dual-mode
  controllers, held to the reference by one step on seeded states (1e-10).
- Unknown types raise KeyError naming the type, in both packages alike.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from control_box_rst_tpu.core import config as jc

from control_box_rst_tpu_torch.core import config as tc

from torch_port_util import to_np

torch.set_num_threads(1)
TOL = 1e-10
F64 = dict(dtype=torch.float64, device="cpu")
EXAMPLES = jc.__file__.rsplit("/control_box_rst_tpu/", 1)[0] + "/examples/"

BASE = {
    "experiment": {"task": "closed_loop", "T_steps": 5, "dt": 0.1},
    "system": {"type": "serial_integrators", "params": {"nx": 2, "nu": 1}},
    "grid": {"type": "fd", "N": 6, "fd_scheme": "crank_nicolson"},
    "cost": {"type": "quadratic_form", "Q": [[1.0, 0.0], [0.0, 2.0]], "R": [[0.1]],
             "Qf": [[10.0, 0.0], [0.0, 10.0]]},
    "bounds": {"u_min": -1.0, "u_max": 1.0},
    "x0": [1.0, -0.2],
    "solver": {"max_iter": 6},
}
TIME_OPT = {"xf": [0.0, 0.0], "xf_fixed": [1.0, 1.0],
            "bounds": {"u_min": -1.0, "u_max": 1.0, "dt_min": 1e-3, "dt_max": 0.5}}
VDP = {"system": {"type": "van_der_pol", "params": {"a": 1.5}}}

GRIDS = {
    "fd": ({"type": "fd", "N": 6, "fd_scheme": "backward", "cost_integration": "trapezoidal"}, {}),
    "fd_hermite_simpson": ({"type": "fd", "N": 6, "fd_scheme": "hermite_simpson",
                            "cost_integration": "hermite_simpson"}, VDP),
    "fd_variable": ({"type": "fd_variable", "N": 6}, TIME_OPT),
    "fd_variable_non_uniform": ({"type": "fd_variable_non_uniform", "N": 6}, TIME_OPT),
    "multiple_shooting": ({"type": "multiple_shooting", "N": 6, "integrator": "rk3",
                           "substeps": 2}, VDP),
    "multiple_shooting_variable": ({"type": "multiple_shooting_variable", "N": 6}, TIME_OPT),
    "multiple_shooting_variable_non_uniform": (
        {"type": "multiple_shooting_variable_non_uniform", "N": 6, "integrator": "rk2"}, TIME_OPT),
    "move_blocking": ({"type": "move_blocking", "N": 6, "blocks": [2, 3, 1]}, {}),
    "hermite_simpson_uncompressed": ({"type": "hermite_simpson_uncompressed", "N": 6}, VDP),
}

COSTS = {
    "quadratic_form": {"type": "quadratic_form", "Q": [[1.0, 0.2], [0.2, 2.0]], "R": [[0.3]]},
    "quadratic_form_integral_qf": {"type": "quadratic_form", "integral": True,
                                   "Qf": [[5.0, 0.0], [0.0, 5.0]]},
    "quadratic_state": {"type": "quadratic_state", "Q": [[2.0, 0.0], [0.0, 1.0]],
                        "Qf": [[3.0, 0.0], [0.0, 3.0]]},
    "quadratic_control": {"type": "quadratic_control", "R": [[0.5]]},
    "minimum_time": {"type": "minimum_time", "weight": 2.0},
    "minimum_time_lsq": {"type": "minimum_time", "weight": 3.0, "lsq_form": True},
    "minimum_time_regularized": {"type": "minimum_time_regularized", "weight": 1.5, "reg": 0.2},
    "min_time_quadratic": {"type": "min_time_quadratic", "time_weight": 0.7,
                           "Q": [[1.0, 0.0], [0.0, 1.0]], "R": [[0.1]]},
    "min_time_quadratic_gain_scheduled": {
        "type": "min_time_quadratic_gain_scheduled", "time_weight": 1.0,
        "Q": [[1.0, 0.0], [0.0, 1.0]], "R": [[0.1]], "radius": 0.5, "sharpness": 4.0,
        "soft_x_max": [10.0, 0.6], "soft_weight": 20.0, "Qf": [[10.0, 0.0], [0.0, 10.0]]},
    "soft_min_only": {"type": "quadratic_form", "soft_x_min": [-0.5, -0.3]},
}
# costs that need a free dt
TIMED = ("minimum_time", "minimum_time_lsq", "minimum_time_regularized", "min_time_quadratic",
         "min_time_quadratic_gain_scheduled")

CONSTRAINTS = {
    "terminal_ball": {"terminal_ball": {"S": [[1.0, 0.1], [0.1, 2.0]], "gamma": 0.04}},
    "terminal_equality": {"terminal_equality": True},
    "terminal_partial_equality": {"terminal_partial_equality": [0]},
}


def _cfg(**parts):
    cfg = copy.deepcopy(BASE)
    for k, v in parts.items():
        cfg[k] = copy.deepcopy(v)
    return cfg


def _random_W(ocp_t, seed):
    """A stage matrix [N+1, nz]: states and controls from a seed, dts in
    [0.05, 0.3] (the grid's pinned dt where it is fixed), stage N's dummy
    control and dt 0."""
    rng = np.random.default_rng(seed)
    nx, nu, N = ocp_t.nx, ocp_t.nu, ocp_t.N
    W = 0.6 * rng.standard_normal((N + 1, ocp_t.nz))
    W[:, nx + nu] = rng.uniform(0.05, 0.3, N + 1) if ocp_t.grid.dt_is_variable else 0.1
    W[-1, nx:nx + nu + 1] = 0.0
    return W


def _evaluations(ocp, W):
    J, K, c = ocp.interval_jacobians(W)
    rows, rl, ru = ocp.general_rows(W)
    return dict(res=ocp.interval_residuals(W), J=J, K=K, c=c, obj=ocp.objective_from_W(W),
                grad=ocp.cost_gradient(W), H=ocp.cost_hessian_blocks(W), rows=rows,
                rl=rl, ru=ru)


def _hold_ocps(cfg, seeds=(0, 1)):
    ocp_j, sys_j = jc.build_ocp(copy.deepcopy(cfg))
    ocp_t, sys_t = tc.build_ocp(copy.deepcopy(cfg), **F64)
    assert type(sys_t).__name__ == type(sys_j).__name__
    assert (ocp_t.N, ocp_t.nx, ocp_t.nu, ocp_t.nz, ocp_t.nc, ocp_t.n_aux, ocp_t.n_tie,
            ocp_t.ng) == (ocp_j.N, ocp_j.nx, ocp_j.nu, ocp_j.nz, ocp_j.nc, ocp_j.n_aux,
                          ocp_j.n_tie, ocp_j.ng)
    assert type(ocp_t.cost).__name__ == type(ocp_j.cost).__name__
    assert bool(ocp_t.cost.integral) == bool(ocp_j.cost.integral)
    assert ocp_t.grid.dt_is_variable == bool(ocp_j.grid.dt_is_variable)
    for a, b in zip(ocp_t.w_bounds(), jax.jit(ocp_j.w_bounds)()):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    np.testing.assert_array_equal(to_np(ocp_t.fixed_mask()), np.asarray(ocp_j.fixed_mask()))
    for key in ("x0", "xf", "xf_fixed"):
        a, b = getattr(ocp_t.bc, key), getattr(ocp_j.bc, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
    for seed in seeds:
        W = _random_W(ocp_t, seed)
        got = _evaluations(ocp_t, torch.as_tensor(W))
        want = jax.jit(lambda w: _evaluations(ocp_j, w))(jnp.asarray(W))
        for key in want:
            np.testing.assert_allclose(to_np(got[key]), np.asarray(want[key]), rtol=0,
                                       atol=TOL, err_msg=key)
    return ocp_j, ocp_t


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_types_match_jax(grid):
    g, extra = GRIDS[grid]
    cost = {"type": "minimum_time"} if extra is TIME_OPT else BASE["cost"]
    _hold_ocps(_cfg(grid=g, cost=cost, **extra))


@pytest.mark.parametrize("cost", list(COSTS))
def test_cost_types_match_jax(cost):
    grid = {"type": "fd_variable", "N": 6} if cost in TIMED else BASE["grid"]
    extra = TIME_OPT if cost in TIMED else {}
    _hold_ocps(_cfg(grid=grid, cost=COSTS[cost], **extra))


def test_config6_composite_is_built_without_its_integral():
    cfg = yaml.safe_load(open(EXAMPLES + "config6_hermite_simpson.yaml"))
    ocp_j, ocp_t = _hold_ocps(cfg, seeds=(2,))
    assert type(ocp_t.cost).__name__ == "CompositeCost"
    assert ocp_t.cost.integral is False and bool(ocp_j.cost.integral) is False
    assert ocp_t.cost.costs[0].integral is True and bool(ocp_j.cost.costs[0].integral) is True


@pytest.mark.parametrize("form", list(CONSTRAINTS))
def test_constraint_forms_match_jax(form):
    _, ocp_t = _hold_ocps(_cfg(constraints=CONSTRAINTS[form], xf=[0.1, 0.0]))
    assert ocp_t.ng > 0


def test_plants_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 2))
    u = rng.standard_normal((6, 1))
    plants = [
        {},
        {"integrator": {"type": "rk2", "substeps": 3}, "output": "first"},
        {"output": [[1.0, 0.5], [0.0, 2.0], [1.0, 1.0]],
         "system": {"type": "duffing", "params": {"damping": 0.4}}},
        {"integrator": {"type": "euler", "substeps": 1},
         "system": {"type": "double_integrator_discrete", "params": {"dt": 0.2}}},
    ]
    for pc in plants:
        cfg = _cfg(plant=pc)
        _, sys_j = jc.build_ocp(cfg)
        jp = jc.build_plant(cfg, sys_j)
        tp = tc.build_plant(cfg, tc.build_ocp(cfg, **F64)[1], **F64)
        assert (tp.output_kind, tp.ny, tp.nx) == (jp.output_kind, jp.ny, jp.nx)
        assert type(tp.system).__name__ == type(jp.system).__name__
        if tp.system.continuous_time:
            assert (tp.integrator.name, tp.integrator.num_substeps) == (
                jp.integrator.name, jp.integrator.num_substeps)
        for i in range(x.shape[0]):
            xs = jp.step(jnp.asarray(x[i]), jnp.asarray(u[i]), 0.1, jax.random.PRNGKey(0))
            ys = jp.output(jnp.asarray(x[i]), jax.random.PRNGKey(0))
            np.testing.assert_allclose(
                tp.step(torch.as_tensor(x[i:i + 1]), torch.as_tensor(u[i:i + 1]), 0.1)[0].numpy(),
                np.asarray(xs), rtol=0, atol=1e-12)
            np.testing.assert_allclose(tp.output(torch.as_tensor(x[i:i + 1]))[0].numpy(),
                                       np.asarray(ys), rtol=0, atol=1e-12)
    noisy = _cfg(plant={"noise": {"state_std": 0.1, "output_std": 0.02, "input_std": 0.0}})
    jp = jc.build_plant(noisy, jc.build_ocp(noisy)[1])
    tp = tc.build_plant(noisy, tc.build_ocp(noisy, **F64)[1], **F64)
    for key in ("state_noise", "output_noise", "input_noise"):
        a, b = getattr(tp, key), getattr(jp, key)
        assert (a is None) == (b is None), key
        if a is not None:
            assert float(a.std) == float(b.std)


@pytest.mark.parametrize("case", ["config5", "linear_output"])
def test_kalman_observer_matches_jax(case):
    if case == "config5":
        cfg = yaml.safe_load(open(EXAMPLES + "config5_kalman_dual_mode.yaml"))
    else:
        cfg = _cfg(plant={"output": [[1.0, 0.5]]},
                   observer={"type": "kalman", "W": [[0.01, 0.0], [0.0, 0.02]], "V": [[0.003]]},
                   system={"type": "duffing", "params": {"damping": 0.5}})
    jp = jc.build_plant(cfg, jc.build_ocp(cfg)[1])
    tp = tc.build_plant(cfg, tc.build_ocp(cfg, **F64)[1], **F64)
    jo, to = jc.build_observer(cfg, jp), tc.build_observer(cfg, tp, **F64)
    for key in ("Ad", "Bd", "C", "L"):
        np.testing.assert_allclose(to_np(getattr(to, key)), np.asarray(getattr(jo, key)),
                                   rtol=0, atol=TOL, err_msg=key)
    none = _cfg(observer={"type": "none"})
    assert type(tc.build_observer(none, tp, **F64)).__name__ == "NoObserver"
    assert type(tc.build_observer(_cfg(), tp, **F64)).__name__ == "NoObserver"


@pytest.mark.parametrize("solver", ["sqp", "ip", "lm"])
def test_predictive_solver_settings_match_jax(solver):
    s = {"type": solver, "max_iter": 7, "qp_max_iter": 120, "qp_tol": 1e-7,
         "tol_stat": 2e-6, "tol_feas": 3e-7, "mu_init": 0.05}
    if solver == "ip":
        s["tol"] = 1e-6
    cfg = _cfg(solver=s)
    jctrl, _ = jc.build_controller(copy.deepcopy(cfg))
    tctrl, _ = tc.build_controller(copy.deepcopy(cfg), **F64)
    assert tctrl.solver == jctrl.solver and tctrl.horizon == jctrl.horizon
    assert (tctrl.nx, tctrl.nu, tctrl.dt) == (jctrl.nx, jctrl.nu, jctrl.dt)
    for key in ("max_iter", "tol_stat", "tol_feas"):
        assert getattr(tctrl.cfg, key) == getattr(jctrl.cfg, key), key
    for key in ("max_iter", "tol"):
        assert getattr(tctrl.cfg.qp, key) == getattr(jctrl.cfg.qp, key), key
    if solver == "ip":
        for key in ("max_iter", "tol", "mu_init"):
            assert getattr(tctrl.ip_cfg, key) == getattr(jctrl.ip_cfg, key), key
    if solver == "lm":
        for key in ("max_iter", "mu_init", "feas_tol"):
            assert getattr(tctrl.lm_cfg, key) == getattr(jctrl.lm_cfg, key), key
    # defaults, as the reference sets them
    d_j, _ = jc.build_controller(_cfg(solver={"type": solver}))
    d_t, _ = tc.build_controller(_cfg(solver={"type": solver}), **F64)
    assert (d_t.cfg.max_iter, d_t.cfg.qp.max_iter, d_t.cfg.qp.tol, d_t.cfg.tol_stat,
            d_t.cfg.tol_feas) == (d_j.cfg.max_iter, d_j.cfg.qp.max_iter, d_j.cfg.qp.tol,
                                  d_j.cfg.tol_stat, d_j.cfg.tol_feas)


ADAPTATIONS = {
    "time_based_single_step": {"dt_ref": 0.12, "dt_hyst_ratio": 0.2, "n_min": 3, "n_max": 12},
    "time_based_aggressive": {"dt_ref": 0.08},
    "shrinking_horizon": {"n_min": 4},
    "redundant_controls": {"epsilon": 0.1, "backup": 1, "n_min": 5},
    "grow_on_infeasibility": {"feas_tol": 1e-4, "n_max": 30},
}


@pytest.mark.parametrize("kind", list(ADAPTATIONS))
def test_adaptation_kinds_match_jax(kind):
    ctrl = {"type": "predictive", "adaptation": {"type": kind, **ADAPTATIONS[kind]},
            "n_active_init": 4, "warm_start_shift": False}
    cfg = _cfg(controller=ctrl, grid={"type": "fd_variable_non_uniform", "N": 8},
               cost={"type": "minimum_time"}, **TIME_OPT)
    jctrl, _ = jc.build_controller(copy.deepcopy(cfg))
    tctrl, _ = tc.build_controller(copy.deepcopy(cfg), **F64)
    ja, ta = jctrl.adaptation, tctrl.adaptation
    assert type(ta).__name__ == type(ja).__name__
    import dataclasses

    for f in dataclasses.fields(ta):
        assert float(getattr(ta, f.name)) == float(getattr(ja, f.name)), f.name
    assert (tctrl.n_active_init, tctrl.warm_start_shift) == (
        jctrl.n_active_init, jctrl.warm_start_shift)


CLASSIC = {
    "lqr": {"type": "lqr", "Q": [[2.0, 0.0], [0.0, 1.0]], "R": [[0.5]]},
    "pid": {"type": "pid", "p_gain": 2.0, "i_gain": 0.3, "d_gain": 0.1},
    "simple_state": {"type": "simple_state", "K": [[1.0, 1.5]]},
    "simple_state_prefilter": {"type": "simple_state", "K": [[1.0, 1.5]], "V": [[0.5, 0.0]]},
    "step_response": {"type": "step_response", "u_step": [0.5], "u_init": [-0.1],
                      "t_step": 0.25},
}


@pytest.mark.parametrize("kind", list(CLASSIC))
def test_classic_controllers_match_jax(kind):
    cfg = _cfg(controller=CLASSIC[kind], xf=[0.2, -0.1])
    jctrl, _ = jc.build_controller(copy.deepcopy(cfg))
    tctrl, _ = tc.build_controller(copy.deepcopy(cfg), **F64)
    assert type(tctrl).__name__ == type(jctrl).__name__
    rng = np.random.default_rng(9)
    xs = rng.standard_normal((3, 4, 2))
    tcarry = tctrl.init_carry(torch.as_tensor(xs[0]))
    jcarries = [jctrl.init_carry(jnp.asarray(x)) for x in xs[0]]
    for k, x in enumerate(xs):
        t = 0.1 * k * 2
        tcarry, tout = tctrl.step(tcarry, torch.as_tensor(x), t, 0.1)
        for lane in range(x.shape[0]):
            jcarries[lane], jout = jctrl.step(jcarries[lane], jnp.asarray(x[lane]), t, 0.1)
            np.testing.assert_allclose(tout.u[lane].numpy(), np.asarray(jout.u), rtol=0, atol=TOL)


def test_dual_mode_controller_matches_jax():
    cfg = yaml.safe_load(open(EXAMPLES + "config5_kalman_dual_mode.yaml"))
    cfg["grid"]["N"] = 8
    jctrl, _ = jc.build_controller(copy.deepcopy(cfg))
    tctrl, _ = tc.build_controller(copy.deepcopy(cfg), **F64)
    assert (float(tctrl.gamma), bool(tctrl.latch)) == (float(jctrl.gamma), bool(jctrl.latch))
    for key in ("S", "xf"):
        np.testing.assert_array_equal(to_np(getattr(tctrl, key)), np.asarray(getattr(jctrl, key)))
    np.testing.assert_allclose(to_np(tctrl.local_controller.K),
                               np.asarray(jctrl.local_controller.K), rtol=0, atol=TOL)
    g_t, g_j = tctrl.global_controller, jctrl.global_controller
    assert g_t.solver == g_j.solver and g_t.cfg.max_iter == g_j.cfg.max_iter == 8
    assert (g_t.cfg.qp.max_iter, g_t.cfg.qp.tol) == (g_j.cfg.qp.max_iter, g_j.cfg.qp.tol)


@pytest.mark.parametrize("where,bad", [
    ("grid", {"type": "no_such_grid"}),
    ("cost", {"type": "nonexistent_cost"}),
    ("observer", {"type": "luenberger"}),
    ("controller", {"type": "no_such_controller"}),
    ("constraints", {"no_such_constraint": 1}),
    ("system", {"type": "no_such_system"}),
    ("experiment", {"task": "no_such_task"}),
])
def test_unknown_types_raise_by_name(where, bad):
    cfg = _cfg(**{where: bad})
    name = next(iter(bad.values())) if where != "constraints" else "no_such_constraint"
    with pytest.raises(KeyError, match=str(name)):
        jc.run_experiment(copy.deepcopy(cfg))
    with pytest.raises(KeyError, match=str(name)):
        tc.run_experiment(copy.deepcopy(cfg), **F64)
