"""Float32 SQP settings of config 4, chosen with the JAX package itself.

Usage:  JAX_PLATFORMS=cpu python tools/config4_calibration.py [OUT.json] [--lanes 64] [--closed-loop]

Config 4 is ``tests/test_golden_nonuniform.py:_config4_ocp``: the double
integrator on ``non_uniform_multiple_shooting_variable_grid(N=10, rk4)``,
``MinimumTime(weight=N, lsq_form=True)``, |u| <= 1, dt in [1e-3, 0.5],
x0 = [d, 0] to xf = 0 pinned. The golden test solves it in float64 with
float64 tolerances; this tool runs the JAX package in float32 (x64 off) on
the CPU, ``jax.jit(jax.vmap(sqp_solve))`` with the non-fused ADMM, for each
candidate ``SQPConfig`` below, on the first ``--lanes`` initial states of
the batch that ``chip_smoke.py`` solves (d ~ U(0.5, 2) from
``numpy.random.default_rng(4)``, 4096 lanes), from the straight-line guess
with dt = 0.1. It reports per candidate: converged fraction, max |T - 2 sqrt(d)|
(T = the sum of the dt_k), mean / max SQP iterations.

``--closed-loop`` also runs the adaptive controller of golden case 9
(``RedundantControls(epsilon=1e-3, backup=1, n_min=2, n_max=15)`` on an
N = 15 grid, ``n_active_init=10``, ``warm_start_shift=False``) for 25 steps
of 0.1 under each candidate, lanes as above with lane 0 at d = 1.5 (the
golden's), ``jax.jit(jax.vmap(run_closed_loop))``: the usable-step
fraction, and lane 0 against the golden test's contract (n_active[0] >= 8,
n_active[10:] <= 5, u[:6] < -0.99, |x_24,pos| < 2e-2).

One JSON object per candidate on stdout, and all of them in OUT.json.
"""
import argparse
import json
import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from control_box_rst_tpu.control import PredictiveController  # noqa: E402
from control_box_rst_tpu.models import DoubleIntegratorContinuous  # noqa: E402
from control_box_rst_tpu.ocp import (  # noqa: E402
    Bounds,
    MinimumTime,
    Trajectory,
    non_uniform_multiple_shooting_variable_grid,
    transcribe,
)
from control_box_rst_tpu.ocp.adaptation import RedundantControls  # noqa: E402
from control_box_rst_tpu.sim import SimulatedPlant, run_closed_loop  # noqa: E402
from control_box_rst_tpu.solvers import QPConfig, SQPConfig, sqp_solve  # noqa: E402

BATCH = 4096
DT_INIT = 0.1

# candidates, the first being config 3's settings (__graft_entry__.py:115-120)
# with the non-fused ADMM
CANDIDATES = {
    "config3": SQPConfig(max_iter=25, qp=QPConfig(max_iter=80, iters_per_round=40, tol=1e-5),
                         tol_stat=3e-4, tol_feas=1e-5),
    "config3_it40": SQPConfig(max_iter=40, qp=QPConfig(max_iter=80, iters_per_round=40, tol=1e-5),
                              tol_stat=3e-4, tol_feas=1e-5),
    "config3_stat1e-4": SQPConfig(max_iter=40, qp=QPConfig(max_iter=80, iters_per_round=40,
                                                           tol=1e-5),
                                  tol_stat=1e-4, tol_feas=1e-5),
    "config3_qp160": SQPConfig(max_iter=40, qp=QPConfig(max_iter=160, iters_per_round=40,
                                                        tol=1e-6),
                               tol_stat=1e-4, tol_feas=1e-5),
}


def config4_ocp(n):
    grid = non_uniform_multiple_shooting_variable_grid(n, integrator="rk4", substeps=1)
    bounds = Bounds.unbounded(2, 1).with_u(-1.0, 1.0).with_dt(1e-3, 0.5)
    return transcribe(
        DoubleIntegratorContinuous(), grid, MinimumTime(weight=float(n), lsq_form=True),
        bounds=bounds, x0=jnp.array([1.5, 0.0]), xf=jnp.zeros(2),
        xf_fixed=jnp.array([1.0, 1.0]),
    )


def initial_states(lanes):
    d = np.random.default_rng(4).uniform(0.5, 2.0, (BATCH,)).astype(np.float32)[:lanes]
    return np.stack([d, np.zeros_like(d)], axis=1)


def open_loop(cfg, x0s):
    ocp0 = config4_ocp(10)

    def solve_one(x0):
        o = ocp0.replace(bc=ocp0.bc.replace(x0=x0))
        traj0 = Trajectory.linear_interp(x0, jnp.zeros(2), 10, 1, DT_INIT)
        r = sqp_solve(o, traj0, cfg)
        return r.traj.dts, r.status, r.iterations

    t0 = time.perf_counter()
    dts, status, iters = jax.jit(jax.vmap(solve_one))(jnp.asarray(x0s))
    dts = np.asarray(dts, np.float64)
    T = dts.sum(axis=1)
    err = np.abs(T - 2.0 * np.sqrt(x0s[:, 0].astype(np.float64)))
    return dict(
        converged_frac=float(np.mean(np.asarray(status) == 1)),
        max_T_err=float(err.max()), median_T_err=float(np.median(err)),
        lanes_T_err_above_1e3=int((err > 1e-3).sum()),
        mean_sqp_iters=float(np.mean(np.asarray(iters))),
        max_sqp_iters=int(np.max(np.asarray(iters))),
        seconds=time.perf_counter() - t0,
    )


def closed_loop(cfg, x0s):
    n_cap = 15
    ad = RedundantControls(epsilon=1e-3, backup=1, n_min=2, n_max=n_cap)
    ctrl = PredictiveController(
        nx=2, nu=1, ocp=config4_ocp(n_cap), dt=0.1, warm_start_shift=False,
        adaptation=ad, n_active_init=10, cfg=cfg,
    )
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    x0s = np.array(x0s)
    x0s[0] = [1.5, 0.0]
    t0 = time.perf_counter()
    res = jax.jit(jax.vmap(lambda x: run_closed_loop(plant, ctrl, x, T_steps=25, dt=0.1)))(
        jnp.asarray(x0s))
    n_act = np.asarray(res.info["n_active"])
    u = np.asarray(res.u)[..., 0]
    x = np.asarray(res.x_true)
    return dict(
        usable_step_frac=float(np.mean(np.asarray(res.ok))),
        usable_step_frac_first64=float(np.mean(np.asarray(res.ok)[:64])),
        lanes=int(x0s.shape[0]),
        lane0=dict(n_active=n_act[0].tolist(), u_first6=u[0, :6].tolist(),
                   x24_pos=float(x[0, 24, 0])),
        lane0_contract=bool(n_act[0, 0] >= 8 and np.all(n_act[0, 10:] <= 5)
                            and np.all(u[0, :6] < -0.99) and abs(x[0, 24, 0]) < 2e-2),
        mean_abs_x_final=float(np.abs(x[:, -1]).mean()),
        mean_sqp_iters=float(np.mean(np.asarray(res.info["sqp_iters"]))),
        seconds=time.perf_counter() - t0,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?")
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--closed-loop", action="store_true")
    ap.add_argument("--only", nargs="*", help="candidate names (default: all)")
    opts = ap.parse_args()
    x0s = initial_states(opts.lanes)
    out = {}
    for name, cfg in CANDIDATES.items():
        if opts.only and name not in opts.only:
            continue
        rec = dict(open_loop=open_loop(cfg, x0s))
        if opts.closed_loop:
            rec["closed_loop"] = closed_loop(cfg, x0s)
        out[name] = rec
        print(json.dumps({name: rec}), flush=True)
    if opts.out:
        pathlib.Path(opts.out).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
