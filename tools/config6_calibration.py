"""The gates of the config-6 and Kalman dual-mode phases of ``chip_smoke.py``,
and of move blocking, set by the JAX package's own float32 runs.

Usage:  JAX_PLATFORMS=cpu python tools/config6_calibration.py [OUT.json] [--lanes 64]
            [--mb-lanes 1024] [--parts open_loop,closed_loop,dual_mode,move_blocking]

Runs the JAX package in float32 (x64 off) on the CPU, with the float32
settings of the port's entry builders (``entry.hermite_simpson``,
``entry.rollouts_hs``, ``entry.kalman_dual_mode``):

  open_loop    config 6 (``tools/hs_vdp_oracle_golden.py:jax_config6_ocp``)
               on the compressed and the uncompressed grid, SQP max_iter 20,
               tol_stat 1e-4, tol_feas 1e-5, QP 60 iterations in rounds of
               30 at tol 1e-5 (the non-fused ADMM), ``jax.jit(jax.vmap(
               sqp_solve))`` over the first ``--lanes`` lanes of the chip
               batch: converged fraction, max |U - U_oracle| against
               ``tests/golden/torch_hs_vdp_oracle_N20.npz``, mean / max SQP
               iterations, max |U_unc - U_hs|.
  closed_loop  config 6 under MPC (the same settings with 10 SQP iterations
               a step), 40 steps of 0.1 against the simulated Van der Pol
               (RK4, 4 substeps), ``jax.jit(jax.vmap(run_closed_loop))`` over
               the first ``--lanes`` rollouts: the usable-step fraction (the
               gate of ``chip_smoke.py``'s hs_closed_loop phase).
  dual_mode    ``examples/config5_kalman_dual_mode.yaml`` through the JAX
               package's own loader (``core/config.py``) with the output
               noise off and the MPC's SQP settings replaced by the port's
               float32 ones (config 1's tolerances, 8 iterations a step,
               backend 'fused'), one rollout per call of the jitted closed
               loop (unbatched, so the per-lane reference of the fused
               kernel solves every QP), 60 steps, the first ``--lanes``
               initial states of the chip batch: the largest |u| - 1 on the
               steps where MPC acts (the dual-mode phase's box gate is twice
               this), the switch contract, max |x_T|.
  move_blocking
               config 1 (``__graft_entry__._flagship``, N 50, its float32
               settings) on ``move_blocking_grid(50, [5] * 10)``, backend
               'fused' (the one-shot), one lane per call of the jitted
               ``sqp_solve`` (unbatched, so the per-lane reference of the
               fused kernel solves every QP), on the first ``--mb-lanes``
               lanes of config 1's chip batch, at tol_feas
               1e-5 (config 1's) and 1e-6: the largest spread of the controls
               inside a block, the converged fraction, mean SQP iterations,
               and the least objective gap to the unblocked solve (the move
               blocking gates of ``chip_smoke.py``'s grids phase).

One JSON object per part on stdout, all of them in OUT.json.
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
sys.path.insert(0, str(ROOT / "tools"))

import jax  # noqa: E402

import numpy as np  # noqa: E402

GOLDEN = ROOT / "tests" / "golden" / "torch_hs_vdp_oracle_N20.npz"
BATCH = 4096


def dual_mode_initial_states(n: int = BATCH) -> np.ndarray:
    """The batch of ``chip_smoke.py``'s dual-mode phase: x0 = [p, v], p ~
    U(-1.5, 1.5), v ~ U(-0.5, 0.5) from ``default_rng(50)``, lane 0 at the
    YAML's [1, 0]; float32."""
    rng = np.random.default_rng(50)
    x0s = np.stack([rng.uniform(-1.5, 1.5, BATCH), rng.uniform(-0.5, 0.5, BATCH)],
                   axis=1).astype(np.float32)
    x0s[0] = [1.0, 0.0]
    return x0s[:n]


def _vdp_cfg(max_iter):
    from control_box_rst_tpu.solvers import QPConfig, SQPConfig

    return SQPConfig(max_iter=max_iter, qp=QPConfig(max_iter=60, iters_per_round=30, tol=1e-5),
                     tol_stat=1e-4, tol_feas=1e-5)


def open_loop(x0s):
    import jax.numpy as jnp

    from control_box_rst_tpu.ocp.problem import Trajectory
    from control_box_rst_tpu.solvers.sqp import sqp_solve
    from hs_vdp_oracle_golden import N, jax_config6_ocp

    gold = np.load(GOLDEN)
    n = min(len(x0s), len(gold["x0s"]))
    out, Us = {}, {}
    for grid in ("hs", "unc"):
        ocp = jax_config6_ocp(grid, jnp.float32)
        cfg = _vdp_cfg(20)

        def solve_one(x0):
            o = ocp.replace(bc=ocp.bc.replace(x0=x0))
            traj0 = Trajectory.linear_interp(x0, jnp.zeros(2, jnp.float32), N, 1, 0.1)
            traj0 = traj0.replace(dts=traj0.dts.astype(jnp.float32))
            res = sqp_solve(o, traj0, cfg)
            return res.traj.U, res.status, res.iterations

        U, status, iters = jax.jit(jax.vmap(solve_one))(jnp.asarray(x0s))
        U, status, iters = np.asarray(U), np.asarray(status), np.asarray(iters)
        Us[grid] = U
        key = "U" if grid == "hs" else "U_unc"
        out[grid] = dict(
            converged_frac=float((status == 1).mean()),
            max_u_err_vs_f64_oracle=float(np.abs(U[:n] - gold[key][:n]).max()),
            mean_sqp_iterations=float(iters.mean()), max_sqp_iterations=int(iters.max()),
        )
    out["max_u_unc_minus_u_hs"] = float(np.abs(Us["unc"] - Us["hs"]).max())
    return out


def closed_loop(x0s):
    import jax.numpy as jnp

    from control_box_rst_tpu.control import PredictiveController
    from control_box_rst_tpu.models import VanDerPolOscillator
    from control_box_rst_tpu.sim import SimulatedPlant, run_closed_loop
    from hs_vdp_oracle_golden import jax_config6_ocp

    ctrl = PredictiveController(nx=2, nu=1, ocp=jax_config6_ocp("hs", jnp.float32), dt=0.1,
                                cfg=_vdp_cfg(10))
    plant = SimulatedPlant(system=VanDerPolOscillator())
    res = jax.jit(jax.vmap(lambda x: run_closed_loop(plant, ctrl, x, T_steps=40, dt=0.1)))(
        jnp.asarray(x0s))
    ok = np.asarray(res.ok)
    return dict(usable_step_frac=float(ok.mean()), rollouts=int(ok.shape[0]),
                mean_sqp_iterations=float(np.asarray(res.info["sqp_iters"]).mean()),
                mean_abs_x_T=float(np.linalg.norm(np.asarray(res.x_true)[:, -1], axis=-1).mean()))


def dual_mode(x0s):
    import jax.numpy as jnp
    import yaml

    from control_box_rst_tpu.core import config as jconfig
    from control_box_rst_tpu.sim import run_closed_loop
    from control_box_rst_tpu.solvers import QPConfig, SQPConfig

    cfg = yaml.safe_load((ROOT / "examples" / "config5_kalman_dual_mode.yaml").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["plant"]["noise"] = {}
    dual, system = jconfig.build_controller(cfg)
    plant = jconfig.build_plant(cfg, system)
    obs = jconfig.build_observer(cfg, plant)
    mpc = dual.global_controller
    sqp = SQPConfig(max_iter=8, qp=QPConfig(max_iter=12, iters_per_round=12, rho=1.0, tol=1e-5,
                                            backend="fused"),
                    tol_stat=1e-4, tol_feas=1e-5)
    dual = dual.replace(global_controller=mpc.replace(cfg=sqp))
    roll = jax.jit(lambda x: run_closed_loop(plant, dual, x, T_steps=60, dt=0.1, observer=obs))
    viol, contract, x_T, local_end = [], True, [], []
    for x0 in x0s:
        r = roll(jnp.asarray(x0))
        la = np.asarray(r.info["local_active"])
        u = np.abs(np.asarray(r.u))[:, 0]
        viol.append(float(np.max(u[~la] - 1.0, initial=-1.0)))
        inside = (np.asarray(r.x_observed) ** 2).sum(-1) <= 0.09
        contract &= bool((la == np.maximum.accumulate(inside)).all())
        x_T.append(float(np.linalg.norm(np.asarray(r.x_true)[-1])))
        local_end.append(bool(la[-1]))
    return dict(max_u_over_box_on_mpc_steps=max(viol), rollouts=len(x0s),
                switch_contract=contract, local_at_end_frac=float(np.mean(local_end)),
                max_abs_x_T=max(x_T))


def config1_x0s(n: int) -> np.ndarray:
    """The first ``n`` lanes of config 1's chip batch (``default_rng(0)``,
    U(-1, 1), float32 [32768, 2])."""
    return np.random.default_rng(0).uniform(-1.0, 1.0, size=(32768, 2)).astype(np.float32)[:n]


def move_blocking(x0s):
    import jax.numpy as jnp

    from __graft_entry__ import _flagship
    from control_box_rst_tpu.ocp import move_blocking_grid
    from control_box_rst_tpu.ocp.problem import Trajectory
    from control_box_rst_tpu.solvers.sqp import sqp_solve

    ocp_free, cfg = _flagship(50)
    cfg = cfg.replace(qp=cfg.qp.replace(backend="fused"))
    ocp_mb = ocp_free.replace(grid=move_blocking_grid(50, [5] * 10))

    def run(ocp, c):
        def one(x0):
            o = ocp.replace(bc=ocp.bc.replace(x0=x0))
            traj0 = Trajectory.linear_interp(x0, jnp.zeros(2, jnp.float32), 50, 1, 0.1)
            r = sqp_solve(o, traj0.replace(dts=traj0.dts.astype(jnp.float32)), c)
            return r.traj.U, r.objective, r.status, r.iterations

        fn = jax.jit(one)
        outs = [fn(jnp.asarray(x0)) for x0 in x0s]
        return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(4)]

    _, obj_free, _, _ = run(ocp_free, cfg)
    out = {}
    for tol_feas in (1e-5, 1e-6):
        U, obj, status, iters = run(ocp_mb, cfg.replace(tol_feas=tol_feas))
        Ub = U[..., 0].reshape(len(x0s), 10, 5)
        spread = np.abs(Ub - Ub[..., :1]).max(axis=(1, 2))
        gap = obj.astype(np.float64) - obj_free.astype(np.float64)
        out[f"tol_feas_{tol_feas:g}"] = dict(
            max_in_block_spread=float(spread.max()),
            lanes_spread_over_1e_6=int((spread > 1e-6).sum()),
            converged_frac=float((status == 1).mean()),
            mean_sqp_iterations=float(iters.mean()), max_sqp_iterations=int(iters.max()),
            min_objective_gap_vs_unblocked=float(gap.min()))
    out["lanes"] = len(x0s)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?")
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--mb-lanes", type=int, default=1024,
                    help="lanes of the move_blocking part")
    ap.add_argument("--parts", default="open_loop,closed_loop,dual_mode,move_blocking")
    opts = ap.parse_args()
    from hs_vdp_oracle_golden import initial_states

    rec = {}
    for name, fn, x0s in (("open_loop", open_loop, initial_states(opts.lanes)),
                          ("closed_loop", closed_loop, initial_states(opts.lanes)),
                          ("dual_mode", dual_mode, dual_mode_initial_states(opts.lanes)),
                          ("move_blocking", move_blocking, config1_x0s(opts.mb_lanes))):
        if name not in opts.parts.split(","):
            continue
        t0 = time.perf_counter()
        rec[name] = fn(x0s)
        rec[name]["seconds"] = time.perf_counter() - t0
        print(json.dumps({name: rec[name]}), flush=True)
    if opts.out:
        pathlib.Path(opts.out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", False)
    main()
