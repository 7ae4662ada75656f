"""Shared pieces of the tests/test_torch_master*.py files: the example
YAMLs and the dict configs of the JAX package's own config tests
(``tests/test_config_master.py``, ``tests/test_config_extended.py``), run
through both packages' ``run_experiment`` (float64, on the CPU) and held to
each other and to the golden of ``tools/master_golden.py``."""
import copy
import pathlib

import numpy as np
import torch
import yaml

from control_box_rst_tpu.core import config as jc

from control_box_rst_tpu_torch.core import config as tc

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-6
F64 = dict(dtype=torch.float64, device="cpu")
GOLDEN = np.load(ROOT / "tests" / "golden" / "torch_master_examples.npz")
GOLDEN_DIR = ROOT / "tests" / "golden"

# name → (file, T_steps for the test: a cut, or None for the YAML's own)
EXAMPLES = {
    "config1": ("config1_double_integrator.yaml", 3),
    "config2": ("config2_van_der_pol_ms.yaml", 3),
    "config3": ("config3_time_optimal.yaml", None),
    "config4": ("config4_nonuniform_time_optimal.yaml", 1),
    "config5_noise0": ("config5_kalman_dual_mode.yaml", 3),
    "config6": ("config6_hermite_simpson.yaml", 3),
}


def example(name):
    path, cut = EXAMPLES[name]
    cfg = yaml.safe_load((ROOT / "examples" / path).read_text())
    if name == "config5_noise0":
        cfg["plant"]["noise"] = {"output_std": 0.0}
    if cut is not None:
        cfg["experiment"]["T_steps"] = cut
    return cfg


def values(rec, name):
    sig = rec.get(name)
    return np.asarray(sig.get("values", sig.get("matrices")), dtype=np.float64)


def both(cfg):
    return jc.run_experiment(copy.deepcopy(cfg)), tc.run_experiment(copy.deepcopy(cfg), **F64)


def hold_example(name, cfg):
    """Both packages on ``cfg``: names one for one, trajectories within TOL,
    and the port within TOL of the golden's first steps."""
    rj, rt = both(cfg)
    assert list(rt.names()) == list(rj.names())
    open_loop = cfg["experiment"].get("task") == "open_loop"
    keys = (("planned_controls", "planned_states", "rollout_states") if open_loop
            else ("applied_controls", "plant_states", "plant_output", "observed_states"))
    for key in keys:
        np.testing.assert_allclose(values(rt, key), values(rj, key), rtol=0, atol=TOL,
                                   err_msg=key)
    u = values(rt, keys[0])
    x = values(rt, keys[1])
    np.testing.assert_allclose(u, GOLDEN[f"{name}/u"][:len(u)], rtol=0, atol=TOL)
    np.testing.assert_allclose(x, GOLDEN[f"{name}/x"][:len(x)], rtol=0, atol=TOL)
    if not open_loop:
        np.testing.assert_array_equal(values(rt, "controller/sqp_iters"),
                                      GOLDEN[f"{name}/sqp_iters"][:len(u)])
    return rj, rt


# the dict configs of tests/test_config_master.py and tests/test_config_extended.py
MASTER_CONFIG1 = {
    "experiment": {"task": "closed_loop", "T_steps": 40, "dt": 0.1},
    "system": {"type": "serial_integrators", "params": {"nx": 2, "nu": 1}},
    "grid": {"type": "fd", "N": 20, "fd_scheme": "crank_nicolson"},
    "cost": {"type": "quadratic_form", "Q": [[1, 0], [0, 1]], "R": [[0.1]],
             "Qf": [[10, 0], [0, 10]]},
    "bounds": {"u_min": -1.0, "u_max": 1.0},
    "x0": [1.0, 0.0],
    "solver": {"max_iter": 6, "qp_max_iter": 150, "qp_tol": 1e-8},
}
EXT_BASE = {
    "experiment": {"task": "closed_loop", "T_steps": 25, "dt": 0.1},
    "system": {"type": "serial_integrators", "params": {"nx": 2, "nu": 1}},
    "grid": {"type": "fd", "N": 8, "fd_scheme": "crank_nicolson"},
    "cost": {"type": "quadratic_form", "Q": [[1.0, 0.0], [0.0, 1.0]],
             "R": [[0.1]], "Qf": [[10.0, 0.0], [0.0, 10.0]]},
    "bounds": {"u_min": -1.0, "u_max": 1.0},
    "x0": [1.0, 0.0],
    "solver": {"max_iter": 6},
}


def _with(base, **parts):
    cfg = copy.deepcopy(base)
    cfg.update(copy.deepcopy(parts))
    return cfg


TASKS = {
    "master_closed_loop": MASTER_CONFIG1,
    "master_time_optimal": {
        "experiment": {"task": "open_loop", "dt": 0.2},
        "system": {"type": "serial_integrators", "params": {"nx": 2, "nu": 1}},
        "grid": {"type": "fd_variable", "N": 20}, "cost": {"type": "minimum_time"},
        "bounds": {"u_min": -1.0, "u_max": 1.0, "dt_min": 1e-3, "dt_max": 0.5},
        "x0": [1.0, 0.0], "xf": [0.0, 0.0], "xf_fixed": [1.0, 1.0],
        "solver": {"max_iter": 40, "qp_max_iter": 500, "qp_tol": 1e-10}},
    "master_minimum_time_lsq": {
        "experiment": {"task": "open_loop", "dt": 0.2},
        "system": {"type": "serial_integrators", "params": {"nx": 2, "nu": 1}},
        "grid": {"type": "multiple_shooting_variable_non_uniform", "N": 10},
        "cost": {"type": "minimum_time", "weight": 10.0, "lsq_form": True},
        "bounds": {"u_min": -1.0, "u_max": 1.0, "dt_min": 1e-3, "dt_max": 0.5},
        "x0": [1.5, 0.0], "xf": [0.0, 0.0], "xf_fixed": [1.0, 1.0],
        "solver": {"max_iter": 60, "qp_max_iter": 1000, "qp_tol": 1e-10}},
    "ext_plant_options": _with(EXT_BASE, plant={
        "integrator": {"type": "rk4", "substeps": 2}, "output": "full",
        "noise": {"output_std": 0.0}, "x0": [0.8, 0.1]}),
    "ext_kalman": _with(EXT_BASE, plant={"output": "first", "noise": {"output_std": 0.0}},
                        observer={"type": "kalman", "V": [[0.0004]]}),
    "ext_dual_mode": _with(
        EXT_BASE, experiment={"task": "closed_loop", "T_steps": 40, "dt": 0.1},
        controller={"type": "dual_mode", "local": {"Q": [[1.0, 0.0], [0.0, 1.0]], "R": [[1.0]]},
                    "S": [[1.0, 0.0], [0.0, 1.0]], "gamma": 0.09, "latch": True}),
    "ext_simple_state": _with(EXT_BASE, controller={"type": "simple_state", "K": [[1.0, 1.5]]}),
    "ext_step_response": _with(EXT_BASE, controller={"type": "step_response", "u_step": [0.5],
                                                     "t_step": 0.5}),
    "ext_terminal_ball": _with(
        EXT_BASE, experiment={"task": "open_loop", "dt": 0.1},
        grid={"type": "fd", "N": 20, "fd_scheme": "crank_nicolson"},
        constraints={"terminal_ball": {"S": [[1.0, 0.0], [0.0, 1.0]], "gamma": 0.04}},
        solver={"max_iter": 20}),
    "ext_gain_scheduled": _with(
        EXT_BASE, grid={"type": "fd_variable", "N": 12},
        bounds={"u_min": -1.0, "u_max": 1.0, "dt_min": 0.02, "dt_max": 0.3},
        cost={"type": "min_time_quadratic_gain_scheduled", "time_weight": 1.0,
              "Q": [[1.0, 0.0], [0.0, 1.0]], "R": [[0.1]], "radius": 0.5,
              "soft_x_max": [10.0, 0.6], "soft_weight": 20.0, "Qf": [[10.0, 0.0], [0.0, 10.0]]},
        xf=[0.0, 0.0], xf_fixed=[1, 1], experiment={"task": "open_loop", "dt": 0.1},
        solver={"max_iter": 25}),
    "ext_increasing_n": _with(EXT_BASE, experiment={
        "task": "benchmark_increasing_n", "dt": 0.1, "benchmark": {"N_values": [6, 12]}}),
    "ext_uncompressed_hs": _with(EXT_BASE, grid={"type": "hermite_simpson_uncompressed", "N": 8}),
    "ext_grow_on_infeasibility": _with(
        EXT_BASE, grid={"type": "fd", "N": 30, "fd_scheme": "crank_nicolson"},
        xf=[0.0, 0.0], xf_fixed=[True, True], x0=[1.5, 0.0],
        solver={"max_iter": 30, "qp": {"max_iter": 1500, "tol": 1e-10}},
        controller={"type": "predictive",
                    "adaptation": {"type": "grow_on_infeasibility", "feas_tol": 1e-4,
                                   "n_max": 30},
                    "n_active_init": 8, "warm_start_shift": False}),
    "varying_x0": _with(EXT_BASE, experiment={
        "task": "benchmark_varying_x0", "T_steps": 10, "dt": 0.1,
        "benchmark": {"x01": [-1.0, 0.0, 1.0], "x02": [-0.5, 0.5]}}),
}
# T_steps of a task in the tests: 6 at most (their own: 40, 25 and 10), the
# grow-on-infeasibility closed loop 1 (its every step runs 30 SQP iterations
# of 200 ADMM iterations on a 30-interval horizon: ~50 s of eager float64 a
# step here)
MAX_STEPS = 6
CUTS = {"ext_grow_on_infeasibility": 1}


def hold_task(name):
    cfg = copy.deepcopy(TASKS[name])
    exp = cfg["experiment"]
    if "T_steps" in exp:
        exp["T_steps"] = min(exp["T_steps"], CUTS.get(name, MAX_STEPS))
    rj, rt = both(cfg)
    assert list(rt.names()) == list(rj.names())
    for key in rj.names():
        a, b = values(rt, key), values(rj, key)
        assert a.shape == b.shape, key
        if key == "benchmark/solve_times":
            assert (a > 0).all()
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=key)
    return rj, rt


CLOSED_LOOP_TASKS = [n for n, c in TASKS.items() if c["experiment"]["task"] != "open_loop"
                     and n != "ext_grow_on_infeasibility"]


