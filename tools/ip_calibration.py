"""Float32 interior-point settings, chosen with the JAX package itself.

Usage:  JAX_PLATFORMS=cpu python tools/ip_calibration.py [OUT.json] [--lanes 64]

Runs the JAX package in float32 (x64 off) on the CPU, ``jax.jit(jax.vmap(...))``,
on the first ``--lanes`` initial states of the batches that ``chip_smoke.py``
solves, for each candidate ``IPConfig`` below:

  config1  config 1's OCP (``__graft_entry__._flagship``, H=50) by
           ``ip_solve`` from the straight line with dt 0.1; x0 from
           ``numpy.random.default_rng(0).uniform(-1, 1)`` over 32768 lanes;
           against ``tests/golden/torch_flagship_oracle_N50.npz``;
  constrained_di  the constrained double integrator of
           ``tools/constrained_di_oracle_golden.py`` (x2 >= -0.9, x_N = 0,
           H=25, dt 0.25) by ``ip_solve``; against
           ``tests/golden/torch_constrained_di_oracle_N25.npz``; the same
           lanes by the SQP of ``entry.constrained_di`` (``SQPConfig(
           max_iter=30)``, non-fused ADMM), and ``--lm-lanes`` of them by
           ``LMConfig(max_iter=60)``, one lane per call (``jax.vmap(lm_solve)``
           over several lanes is lane-dependent on this CPU backend);
  controller  config 5's controller (config 1's OCP under
           ``PredictiveController(solver='ip')``, 5 steps of 0.1 against
           the simulated double integrator) from the first lanes of config 1;
           usable-step fraction, and max |u_ip - u_sqp| against the SQP
           controller (``flagship``'s settings) on the same lanes and steps.

Per candidate: converged fraction, mean / max iterations, max |U - U_oracle|
(and for the constrained DI min x2, max |x_N|), for the JAX package and,
beside it, for the port's own float32 solve of the same lanes on the CPU
(``make_batched_ip_solver(device="cpu")``: the Schur solve's plain version).
The choice: the first candidate with converged >= 0.99 and max |U - U_oracle|
<= 1e-3 in both. Two float32 implementations stop at the KKT tolerance on
different sides of the optimum, and on config 1 (condition ~1e3) the max
over 64 lanes of the resulting U error moves between 5e-4 and 2e-3 with
nothing but rounding: a setting the reference meets by a hair is no
setting for a second implementation.
One JSON object per row on stdout, and all of them in OUT.json.
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from __graft_entry__ import _flagship  # noqa: E402
from constrained_di_oracle_golden import DT, N as DI_N, constrained_di_ocp  # noqa: E402
from control_box_rst_tpu.control import PredictiveController  # noqa: E402
from control_box_rst_tpu.models import DoubleIntegratorContinuous  # noqa: E402
from control_box_rst_tpu.ocp import Trajectory  # noqa: E402
from control_box_rst_tpu.sim import SimulatedPlant, run_closed_loop  # noqa: E402
from control_box_rst_tpu.solvers import (  # noqa: E402
    IPConfig,
    LMConfig,
    SQPConfig,
    ip_solve,
    lm_solve,
    sqp_solve,
)

GOLDEN = ROOT / "tests" / "golden"
GATE_CONV, GATE_ERR = 0.99, 1e-3
CL_STEPS = 5

CONFIG1 = {
    "tol1e-5_it80": dict(tol=1e-5, max_iter=80),
    "tol7e-6_it80": dict(tol=7e-6, max_iter=80),
    "tol1e-6_it100": dict(tol=1e-6, max_iter=100),
    "tol1e-4_it80": dict(tol=1e-4, max_iter=80),
    "default": dict(),
}
CONSTRAINED_DI = {
    "it100": dict(max_iter=100),
    "tol1e-4_it100": dict(tol=1e-4, max_iter=100),
    "tol1e-5_it100": dict(tol=1e-5, max_iter=100),
    "tol7e-6_it100": dict(tol=7e-6, max_iter=100),
    "tol1e-5_it200": dict(tol=1e-5, max_iter=200),
}


def _f32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _solve_batch(ocp, solver, x0s, dt, n):
    assert not jax.config.jax_enable_x64 and x0s.dtype == np.float32

    def one(x0):
        o = ocp.replace(bc=ocp.bc.replace(x0=x0))
        r = solver(o, Trajectory.linear_interp(x0, jnp.zeros(2), n, 1, dt))
        return r.traj.U, r.traj.X, r.status, r.iterations

    t0 = time.perf_counter()
    U, X, st, it = (np.asarray(a) for a in jax.jit(jax.vmap(one))(jnp.asarray(x0s)))
    return U, X, st, it, time.perf_counter() - t0


def _row(U, X, st, it, gold, secs, x_rows=False):
    err = np.abs(U.astype(np.float64) - gold["U"]).max(axis=(1, 2))
    rec = dict(
        converged_frac=float(np.mean(st == 1)), mean_iters=float(it.mean()),
        max_iters=int(it.max()), max_u_err=float(err.max()),
        median_u_err=float(np.median(err)), finite=bool(np.isfinite(U).all()),
        seconds=secs,
    )
    if x_rows:
        rec.update(min_x2=float(X[..., 1].min()), max_abs_xN=float(np.abs(X[:, -1]).max()))
    rec["meets_gate"] = rec["converged_frac"] >= GATE_CONV and rec["max_u_err"] <= GATE_ERR
    return rec


def _port_row(port_ocp, kw, x0s, gold, dt, x_rows=False):
    """The port's own float32 solve of the same lanes on the CPU."""
    import torch

    from control_box_rst_tpu_torch.ocp.problem import Trajectory as TT
    from control_box_rst_tpu_torch.solvers import IPConfig as TIP
    from control_box_rst_tpu_torch.solvers import ip_solve as tip

    x0 = torch.as_tensor(x0s)
    o = port_ocp.replace(bc=port_ocp.bc.replace(x0=x0))
    t0 = time.perf_counter()
    r = tip(o, TT.linear_interp(x0, torch.zeros(2), o.N, 1, dt), TIP(**kw))
    return _row(*(a.numpy() for a in (r.traj.U, r.traj.X, r.status, r.iterations)), gold,
                time.perf_counter() - t0, x_rows)


def _both(rows, key):
    return rows[key]["meets_gate"] and rows[key]["port"]["meets_gate"]


def config1(lanes):
    from control_box_rst_tpu_torch.entry import flagship as port_flagship

    gold = np.load(GOLDEN / "torch_flagship_oracle_N50.npz")
    x0s = gold["x0s"][:lanes]
    ocp = _f32(_flagship(N=50)[0])
    port_ocp, _ = port_flagship(50, device="cpu")
    out = {}
    for name, kw in CONFIG1.items():
        U, X, st, it, s = _solve_batch(
            ocp, lambda o, t, kw=kw: ip_solve(o, t, IPConfig(**kw)), x0s, 0.1, 50)
        out[name] = _row(U, X, st, it, gold, s)
        out[name]["port"] = _port_row(port_ocp, kw, x0s, gold, 0.1)
        print(json.dumps({"config1": {name: out[name]}}), flush=True)
    return out


def constrained_di(lanes, lm_lanes):
    from control_box_rst_tpu_torch.entry import constrained_di as port_di

    gold = np.load(GOLDEN / "torch_constrained_di_oracle_N25.npz")
    x0s = gold["x0s"][:lanes]
    ocp = _f32(constrained_di_ocp())
    port_ocp = port_di(device="cpu")[0]
    out = {}
    for name, kw in CONSTRAINED_DI.items():
        U, X, st, it, s = _solve_batch(
            ocp, lambda o, t, kw=kw: ip_solve(o, t, IPConfig(**kw)), x0s, DT, DI_N)
        out[name] = _row(U, X, st, it, gold, s, x_rows=True)
        out[name]["port"] = _port_row(port_ocp, kw, x0s, gold, DT, x_rows=True)
        print(json.dumps({"constrained_di": {name: out[name]}}), flush=True)
    U, X, st, it, s = _solve_batch(
        ocp, lambda o, t: sqp_solve(o, t, SQPConfig(max_iter=30)), x0s, DT, DI_N)
    assert U.dtype == np.float32
    out["sqp_max_iter30"] = _row(U, X, st, it, gold, s, x_rows=True)
    print(json.dumps({"constrained_di": {"sqp_max_iter30": out["sqp_max_iter30"]}}), flush=True)
    rows = [_solve_batch(ocp, lambda o, t: lm_solve(o, t, LMConfig(max_iter=60)),
                         x0s[i:i + 1], DT, DI_N) for i in range(lm_lanes)]
    U, X, st, it = (np.concatenate([r[k] for r in rows]) for k in range(4))
    viol = np.maximum(0.0, -0.9 - X[..., 1]).max()
    out["lm_max_iter60"] = dict(
        lanes=lm_lanes, converged_frac=float(np.mean(st == 1)), mean_iters=float(it.mean()),
        max_iters=int(it.max()), max_u_err=float(np.abs(U - gold["U"][:lm_lanes]).max()),
        max_x2_violation=float(viol), max_abs_xN=float(np.abs(X[:, -1]).max()),
        seconds=sum(r[4] for r in rows))
    print(json.dumps({"constrained_di": {"lm_max_iter60": out["lm_max_iter60"]}}), flush=True)
    return out


def controller(lanes, ip_cfg):
    from __graft_entry__ import _flagship as flag

    ocp, sqp_cfg = flag(N=50)
    ocp = _f32(ocp)
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    x0s = jnp.asarray(np.load(GOLDEN / "torch_flagship_oracle_N50.npz")["x0s"][:lanes])
    res = {}
    for solver in ("ip", "sqp"):
        ctrl = PredictiveController(nx=2, nu=1, ocp=ocp, dt=0.1, cfg=sqp_cfg, solver=solver,
                                    ip_cfg=ip_cfg)
        t0 = time.perf_counter()
        res[solver] = jax.jit(jax.vmap(
            lambda x: run_closed_loop(plant, ctrl, x, T_steps=CL_STEPS, dt=0.1)))(x0s)
        res[solver + "_s"] = time.perf_counter() - t0
    u_ip, u_sqp = np.asarray(res["ip"].u), np.asarray(res["sqp"].u)
    it = np.asarray(res["ip"].info["sqp_iters"])
    rec = dict(
        steps=CL_STEPS, lanes=lanes, usable_step_frac=float(np.mean(np.asarray(res["ip"].ok))),
        sqp_usable_step_frac=float(np.mean(np.asarray(res["sqp"].ok))),
        max_u_ip_vs_sqp=float(np.abs(u_ip - u_sqp).max()), max_abs_u=float(np.abs(u_ip).max()),
        mean_ip_iters=float(it.mean()), lock_step_ip_iters=it.max(axis=0).tolist(),
        seconds=res["ip_s"],
    )
    print(json.dumps({"controller": rec}), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?")
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--lm-lanes", type=int, default=8)
    opts = ap.parse_args()
    out = dict(config1=config1(opts.lanes), constrained_di=constrained_di(opts.lanes, opts.lm_lanes))
    pick = lambda rows, cands: next((k for k in cands if _both(rows, k)), None)
    out["chosen"] = dict(config1=pick(out["config1"], CONFIG1),
                         constrained_di=pick(out["constrained_di"], CONSTRAINED_DI))
    print(json.dumps({"chosen": out["chosen"]}), flush=True)
    chosen1 = out["chosen"]["config1"] or next(iter(CONFIG1))
    out["controller"] = controller(opts.lanes, IPConfig(**CONFIG1[chosen1]))
    if opts.out:
        pathlib.Path(opts.out).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
