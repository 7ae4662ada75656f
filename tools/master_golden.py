"""The goldens of the port's config loader and master: the JAX package's own
``core/config.py`` runs, in float64 and in float32.

Usage:  JAX_PLATFORMS=cpu python tools/master_golden.py [--out tests/golden]
            [--parts examples,solvers,zoo]

Runs the JAX package's ``run_experiment`` (its own loader, its own closed
loop) on the CPU, once with x64 on (the golden) and once in float32 (the
reference's own float32 run, which calibrates the card's gates):

  examples  the six example YAMLs (``examples/config{1..6}_*.yaml``) at their
            own settings, config 5 with its output noise set to 0
            (``config5_noise0``: the two packages draw noise from different
            generators); closed loops record ``applied_controls``,
            ``plant_states`` and ``controller/sqp_iters``, config 3 (open
            loop) ``planned_controls`` and ``planned_states``
  solvers   config 1's YAML with ``solver: {type: ip}`` and with
            ``solver: {type: lm}``, 10 steps each
  zoo       one open-loop solve of each of the twelve registered systems
            (``ZOO`` below: multiple shooting, RK4, N 20, the quadratic cost,
            each system's own dims): U, X, the SQP iterations and the final
            constraint violation of the float64 solve (``converged``: it
            stopped before ``max_iter``)

For every case the file holds the float64 signals (``<case>/u``,
``<case>/x``, ``<case>/sqp_iters``), the reference's float32 distance from
them per step (``<case>/du32`` = max over components of |u32 − u64| at each
step, ``<case>/dx32`` the same for the states), its maximum over the steps
before the two runs part (``<case>/ref_f32_u``, ``<case>/ref_f32_x``) and
``<case>/part_step``: the first step at which the float32 run's control is
more than ``PART_TOL`` from the float64 one (a decision of the float32 run
that differs: a flip of ``RedundantControls``, a switch of the dual mode;
the number of steps when they never part), ``<case>/ref_f32_usable``: the
usable-step fraction of a closed loop's float32 run (feas_res < 1e-3, the
controller's ``ok``), and ``<case>/config``: the
case's config dict as JSON (the zoo's are defined here only). Files:
``torch_master_examples.npz``, ``torch_master_solvers.npz``,
``torch_master_zoo.npz``.
"""
import argparse
import copy
import json
import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import yaml  # noqa: E402

EXAMPLES = {
    "config1": "config1_double_integrator.yaml",
    "config2": "config2_van_der_pol_ms.yaml",
    "config3": "config3_time_optimal.yaml",
    "config4": "config4_nonuniform_time_optimal.yaml",
    "config5_noise0": "config5_kalman_dual_mode.yaml",
    "config6": "config6_hermite_simpson.yaml",
}
# a float32 control this far from the float64 one is a different decision
PART_TOL = 0.05
SOLVER_STEPS = 10

# one open-loop solve of each registered system: multiple shooting, RK4, N 20,
# dt 0.1, Q = I, R = 0.1 I, Qf = 10 I (state components that the model
# cannot steer, the rocket's mass, carry no weight), bounds wide enough
# tolerances an SQP exit cannot meet in float32 on most of them (the float32
# runs then take max_iter iterations): an exit at float32's tolerances
# (1e-4 on stationarity) leaves U up to ~1e-3 from the optimum, the size of
# the card's gate
ZOO_SOLVER = {"max_iter": 30, "qp_max_iter": 200, "qp_tol": 1e-7,
              "tol_stat": 1e-6, "tol_feas": 1e-7}
ZOO = {
    "serial_integrators": dict(params={"nx": 2, "nu": 1}, x0=[1.0, 0.0], u=1.0),
    "parallel_integrators": dict(params={"nx": 2, "nu": 2}, x0=[1.0, -1.0], u=2.0),
    "linear_state_space": dict(
        params={"A": [[0.0, 1.0], [-1.0, -0.5]], "B": [[0.0], [1.0]]}, x0=[1.0, 0.0], u=2.0),
    "double_integrator_discrete": dict(params={"dt": 0.1}, x0=[1.0, 0.0], u=1.0),
    "van_der_pol": dict(params={"a": 1.0}, x0=[1.0, 0.5], u=2.0),
    "duffing": dict(params={}, x0=[1.0, 0.0], u=2.0),
    "free_space_rocket": dict(params={}, x0=[1.0, 0.0, 1.0], u=1.0, free=[2]),
    "simple_pendulum": dict(params={}, x0=[0.5, 0.0], u=30.0),
    "massless_pendulum": dict(params={}, x0=[0.5, 0.0], u=2.0),
    "cart_pole": dict(params={}, x0=[0.0, 0.3, 0.0, 0.0], u=10.0),
    "toy_example": dict(params={}, x0=[0.4, -0.4], u=2.0),
    "artsteins_circle": dict(params={}, x0=[0.5, 0.5], u=2.0),
}


def example_config(name: str) -> dict:
    cfg = yaml.safe_load((ROOT / "examples" / EXAMPLES[name]).read_text())
    if name == "config5_noise0":
        cfg["plant"]["noise"] = {"output_std": 0.0}
    return cfg


def solver_config(kind: str) -> dict:
    cfg = yaml.safe_load((ROOT / "examples" / EXAMPLES["config1"]).read_text())
    cfg["experiment"]["T_steps"] = SOLVER_STEPS
    cfg["solver"] = {"type": kind}
    return cfg


def zoo_config(name: str) -> dict:
    z = ZOO[name]
    nx = len(z["x0"])
    nu = z["params"].get("nu", len(z["params"]["B"][0]) if "B" in z["params"] else 1)
    w = np.ones(nx)
    w[z.get("free", [])] = 0.0
    return {
        "experiment": {"task": "open_loop", "dt": 0.1},
        "system": {"type": name, "params": dict(z["params"])},
        "grid": {"type": "multiple_shooting", "N": 20, "integrator": "rk4"},
        "cost": {"type": "quadratic_form", "Q": np.diag(w).tolist(),
                 "R": (0.1 * np.eye(nu)).tolist(), "Qf": np.diag(10.0 * w).tolist()},
        "bounds": {"u_min": -z["u"], "u_max": z["u"]},
        "x0": list(z["x0"]),
        "solver": dict(ZOO_SOLVER),
    }


def _values(rec, name):
    return np.asarray(rec.get(name)["values"], dtype=np.float64)


def run_case(cfg: dict, zoo: bool):
    """(u, x, sqp_iters, feas) of the JAX package's run of ``cfg``."""
    import jax.numpy as jnp

    from control_box_rst_tpu.core import config as jc
    from control_box_rst_tpu.sim import run_open_loop

    if zoo:
        ctrl, system = jc.build_controller(copy.deepcopy(cfg))
        plant = jc.build_plant(cfg, system)
        x0 = jnp.asarray(np.asarray(cfg["x0"], dtype=np.float64))
        out, _ = run_open_loop(plant, ctrl, x0, float(cfg["experiment"]["dt"]))
        return (np.asarray(out.u_seq, np.float64), np.asarray(out.x_seq, np.float64),
                np.asarray(out.info["sqp_iters"]).reshape(1),
                np.asarray(out.info["feas_res"], np.float64).reshape(1))
    rec = jc.run_experiment(copy.deepcopy(cfg))
    if cfg["experiment"].get("task", "closed_loop") == "open_loop":
        return _values(rec, "planned_controls"), _values(rec, "planned_states"), None, None
    return (_values(rec, "applied_controls"), _values(rec, "plant_states"),
            _values(rec, "controller/sqp_iters"), _values(rec, "controller/feas_res"))


def golden_of(cases: dict, zoo: bool = False) -> dict:
    import jax

    out = {}
    for name, cfg in cases.items():
        t0 = time.perf_counter()
        u64, x64, it64, feas64 = run_case(cfg, zoo)
        t64 = time.perf_counter() - t0
        with jax.enable_x64(False):
            u32, x32, _, feas32 = run_case(cfg, zoo)
        t32 = time.perf_counter() - t0 - t64
        du = np.abs(u32 - u64).reshape(u64.shape[0], -1).max(axis=1)
        dx = np.abs(x32 - x64).reshape(x64.shape[0], -1).max(axis=1)
        parted = np.nonzero(du > PART_TOL)[0]
        part = int(parted[0]) if parted.size else int(du.shape[0])
        out[f"{name}/config"] = np.asarray(json.dumps(cfg))
        out[f"{name}/u"], out[f"{name}/x"] = u64, x64
        out[f"{name}/du32"], out[f"{name}/dx32"] = du, dx
        out[f"{name}/part_step"] = np.asarray(part)
        out[f"{name}/ref_f32_u"] = np.asarray(du[:part].max() if part else 0.0)
        # x_{k+1} follows u_k: the states up to the parting step's
        out[f"{name}/ref_f32_x"] = np.asarray(dx[:part + 1].max())
        if it64 is not None:
            out[f"{name}/sqp_iters"] = np.asarray(it64, np.float64)
            out[f"{name}/feas_res"] = np.asarray(feas64, np.float64)
        if feas32 is not None and not zoo:
            # usable steps of the float32 run: the controller's ok, feas < 1e-3
            out[f"{name}/ref_f32_usable"] = np.asarray(float((feas32 < 1e-3).mean()))
        if zoo:
            out[f"{name}/converged"] = np.asarray(bool(it64[0] < cfg["solver"]["max_iter"]))
        print(f"{name}: f64 {t64:.1f} s, f32 {t32:.1f} s; f32 from f64: u {du.max():.3e} "
              f"x {dx.max():.3e}, part at step {part} of {du.shape[0]}"
              + (f"; f64 {int(it64[0])} SQP iterations, feas {float(feas64[0]):.2e}" if zoo else ""),
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "golden"))
    ap.add_argument("--parts", default="examples,solvers,zoo")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    parts = args.parts.split(",")
    if "examples" in parts:
        data = golden_of({n: example_config(n) for n in EXAMPLES})
        np.savez_compressed(os.path.join(args.out, "torch_master_examples.npz"), **data)
    if "solvers" in parts:
        data = golden_of({f"config1_{k}": solver_config(k) for k in ("ip", "lm")})
        np.savez_compressed(os.path.join(args.out, "torch_master_solvers.npz"), **data)
    if "zoo" in parts:
        data = golden_of({n: zoo_config(n) for n in ZOO}, zoo=True)
        np.savez_compressed(os.path.join(args.out, "torch_master_zoo.npz"), **data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
