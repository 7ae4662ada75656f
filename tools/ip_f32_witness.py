"""Float32 interior-point behaviour of the JAX package and the port, lane for lane.

Usage:  JAX_PLATFORMS=cpu python tools/ip_f32_witness.py [OUT.json]
            [--lanes 2048] [--capped i,j,...] [--slow i,j,...]

Both packages in float32 on the CPU, on the same lanes, with the settings
``entry.IP_F32_CONFIG1`` / ``entry.IP_F32_CONSTRAINED_DI`` (and config 1 at
the first candidate of ``tools/ip_calibration.py``, tol 1e-5):

  config1  config 1's OCP by ``ip_solve`` from the straight line with dt
           0.1; x0 from ``numpy.random.default_rng(0).uniform(-1, 1)`` over
           32768 lanes (``chip_smoke.py``'s batch): the first ``--lanes``
           and the lanes ``--capped`` (the lanes that ran to the iteration
           cap on the card, ``capped_lanes`` of the ``{"ip": ...}`` line);
  constrained_di  the constrained double integrator (``chip_smoke.py``'s
           4096 lanes, d ~ U(-2, 2) from ``default_rng(6)``, lane 0 at d = 2):
           the first ``--lanes`` and the lanes ``--slow`` (the card's
           ``most_iterations`` lanes).

The yardstick is the port's float64 solve of the same lanes (``IPConfig()``
at float64: tol 1e-8; the tests hold it to the JAX package's float64 solve
at 1e-8). Per package: converged fraction, the lanes at the iteration cap,
mean / max iterations, and max / p99 / median over lanes of
max |U - U_f64|; per named lane both packages' iterations and status. It
answers whether the reference caps, or creeps, where the port does, and
whether the port's U error is drawn from the reference's distribution.
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
import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from __graft_entry__ import _flagship  # noqa: E402
from constrained_di_oracle_golden import DT, N as DI_N, constrained_di_ocp  # noqa: E402
from control_box_rst_tpu.ocp import Trajectory  # noqa: E402
from control_box_rst_tpu.solvers import IPConfig, ip_solve  # noqa: E402
from control_box_rst_tpu_torch import entry  # noqa: E402
from control_box_rst_tpu_torch.ocp.problem import Trajectory as TTrajectory  # noqa: E402
from control_box_rst_tpu_torch.solvers import IPConfig as TIPConfig  # noqa: E402
from control_box_rst_tpu_torch.solvers import ip_solve as t_ip_solve  # noqa: E402

CHUNK = 512  # lanes per call, to bound the memory of a CPU run


def _f32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def config1_x0s():
    return np.random.default_rng(0).uniform(-1.0, 1.0, size=(32768, 2)).astype(np.float32)


def constrained_di_x0s():
    d = np.random.default_rng(6).uniform(-2.0, 2.0, size=4096)
    d[0] = 2.0
    return np.stack([d, np.zeros(4096)], axis=1).astype(np.float32)


def jax_f32(ocp, kw, x0s, dt, n):
    """(U, iterations, status) of the JAX package, float32, jit(vmap)."""

    def one(x0):
        o = ocp.replace(bc=ocp.bc.replace(x0=x0))
        r = ip_solve(o, Trajectory.linear_interp(x0, jnp.zeros(2), n, 1, dt), IPConfig(**kw))
        return r.traj.U, r.iterations, r.status

    fn = jax.jit(jax.vmap(one))
    outs = [fn(jnp.asarray(x0s[i:i + CHUNK])) for i in range(0, len(x0s), CHUNK)]
    return [np.concatenate([np.asarray(o[k]) for o in outs]) for k in range(3)]


def port(ocp, kw, x0s, dt):
    """(U, iterations, status) of the port on the CPU in the OCP's dtype."""
    outs = []
    for i in range(0, len(x0s), CHUNK):
        x0 = torch.as_tensor(x0s[i:i + CHUNK]).to(ocp.bc.x0.dtype)
        o = ocp.replace(bc=ocp.bc.replace(x0=x0))
        r = t_ip_solve(o, TTrajectory.linear_interp(x0, torch.zeros_like(x0[0]), o.N, 1, dt),
                       TIPConfig(**kw))
        outs.append((r.traj.U, r.iterations, r.status))
    return [torch.cat([o[k] for o in outs]).numpy() for k in range(3)]


def summary(U, it, st, U64, max_iter, lanes):
    err = np.abs(U.astype(np.float64) - U64).max(axis=(1, 2))
    capped = np.flatnonzero(it >= max_iter)
    return dict(
        converged_frac=float(np.mean(st == 1)), mean_iters=float(it.mean()),
        max_iters=int(it.max()), n_capped=int(capped.size),
        capped_lanes=[int(lanes[i]) for i in capped],
        max_u_err=float(err.max()), p99_u_err=float(np.percentile(err, 99)),
        median_u_err=float(np.median(err)),
    ), err


def compare(name, jax_ocp, port32, port64, kw, x0s_all, lanes, named, dt, n):
    t0 = time.perf_counter()
    idx = np.asarray(sorted(set(lanes) | set(named)), dtype=np.int64)
    x0s = x0s_all[idx]
    U64, it64, st64 = port(port64, dict(max_iter=200), x0s.astype(np.float64), dt)
    Uj, itj, stj = jax_f32(jax_ocp, kw, x0s, dt, n)
    Up, itp, stp = port(port32, kw, x0s, dt)
    first = np.isin(idx, lanes)
    rec = dict(
        settings=kw, lanes=int(first.sum()), f64_converged_frac=float(np.mean(st64 == 1)),
        f64_max_iters=int(it64.max()),
    )
    rec["jax"], ej = summary(Uj[first], itj[first], stj[first], U64[first], kw["max_iter"],
                             idx[first])
    rec["port"], ep = summary(Up[first], itp[first], stp[first], U64[first], kw["max_iter"],
                              idx[first])
    pos = {int(k): i for i, k in enumerate(idx)}
    rec["named_lanes"] = [dict(
        lane=int(k), x0=x0s_all[k].tolist(), f64_iters=int(it64[pos[k]]),
        jax_iters=int(itj[pos[k]]), jax_status=int(stj[pos[k]]), jax_u_err=float(ej_k),
        port_iters=int(itp[pos[k]]), port_status=int(stp[pos[k]]), port_u_err=float(ep_k),
    ) for k in named for ej_k, ep_k in [(
        np.abs(Uj[pos[k]].astype(np.float64) - U64[pos[k]]).max(),
        np.abs(Up[pos[k]].astype(np.float64) - U64[pos[k]]).max())]]
    # the slowest lanes of each package among the first ones, with the other's count
    for who, it_own, it_other in (("jax", itj, itp), ("port", itp, itj)):
        order = np.argsort(-it_own[first], kind="stable")[:8]
        rec[who]["slowest"] = [dict(lane=int(idx[first][i]), iters=int(it_own[first][i]),
                                    other_iters=int(it_other[first][i]),
                                    x0=x0s[first][i].tolist()) for i in order]
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps({name: rec}), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?")
    ap.add_argument("--lanes", type=int, default=2048)
    ap.add_argument("--capped", default="", help="config-1 lanes, comma-separated")
    ap.add_argument("--slow", default="", help="constrained-DI lanes, comma-separated")
    opts = ap.parse_args()
    ints = lambda s: [int(v) for v in s.split(",") if v]
    torch.set_num_threads(4)
    lanes = list(range(opts.lanes))

    c1_jax = _f32(_flagship(N=50)[0])
    c1_32 = entry.flagship(50, device="cpu")[0]
    c1_64 = entry.flagship(50, dtype=torch.float64, device="cpu")[0]
    di_jax = _f32(constrained_di_ocp())
    di_32 = entry.constrained_di(device="cpu")[0]
    di_64 = entry.constrained_di(dtype=torch.float64, device="cpu")[0]
    out = {}
    for name, kw in (("config1", entry.IP_F32_CONFIG1),
                     ("config1_tol1e-5", dict(tol=1e-5, max_iter=80))):
        out[name] = compare(name, c1_jax, c1_32, c1_64, kw, config1_x0s(), lanes,
                            ints(opts.capped), 0.1, 50)
    out["constrained_di"] = compare(
        "constrained_di", di_jax, di_32, di_64, entry.IP_F32_CONSTRAINED_DI,
        constrained_di_x0s(), lanes, ints(opts.slow), DT, DI_N)
    if opts.out:
        pathlib.Path(opts.out).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
