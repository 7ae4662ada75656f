"""CPU oracle of the batched Levenberg-Marquardt solve on config 1 (subprocess
tool): the JAX package's ``lm_solve`` on the ``_flagship`` OCP, in float64 and
in float32, one lane at a time.

Usage:  python tools/lm_oracle_solve.py OUT.npz [n_lanes] [N]

  OUT.npz: x0s [n, 2] float32 — the first ``n_lanes`` (default 64) of the
           benchmark's initial states, numpy ``default_rng(0).uniform(-1, 1)``
           over 32768 lanes;
           U [n, N, 1], chi2, feas_res, iterations, status — the float64 solve
           with ``LMConfig(max_iter=60)`` from the straight-line guess;
           U_f32, chi2_f32, iterations_f32, status_f32 — the same solve in
           true float32 (x64 off), the reference's own float32 answer.

Lanes are solved one per call, as ``jax.jit(jax.vmap(lm_solve))`` over a
batch of one: on the CPU backend the solve vmapped over several lanes gives
lane-dependent answers (four identical initial states come back as three
different trajectories after one iteration), and the un-vmapped jitted solve
has been seen to abort the process; the batch-of-one form is reproducible.

``tests/golden/torch_lm_oracle_N50.npz`` is this tool's output for the
defaults.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def solve_lanes(x0s, N, dtype):
    from control_box_rst_tpu.ocp.problem import Trajectory
    from control_box_rst_tpu.solvers import LMConfig, lm_solve
    from __graft_entry__ import _flagship

    ocp, _ = _flagship(N=N)
    ocp = jax.tree.map(
        lambda a: a.astype(dtype)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        ocp,
    )
    cfg = LMConfig(max_iter=60)

    def solve_one(x0):
        o = ocp.replace(bc=ocp.bc.replace(x0=x0))
        traj0 = Trajectory.linear_interp(x0, o.refs.xref[-1], N, ocp.nu, 0.1)
        r = lm_solve(o, traj0, cfg)
        return r.traj.U, r.chi2, r.feas_res, r.iterations, r.status

    solve = jax.jit(jax.vmap(solve_one))
    outs = [[np.asarray(a)[0] for a in solve(x0[None].astype(dtype))] for x0 in x0s]
    return [np.stack([o[i] for o in outs]) for i in range(5)]


def main(out_path: str, n_lanes: int = 64, N: int = 50) -> None:
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-1.0, 1.0, size=(32768, 2)).astype(np.float32)[:n_lanes]
    U, chi2, feas, it, status = solve_lanes(x0s, N, np.float64)
    with jax.enable_x64(False):
        U32, chi2_32, _, it32, status32 = solve_lanes(x0s, N, np.float32)
    np.savez(
        out_path, x0s=x0s, U=U, chi2=chi2, feas_res=feas, iterations=it,
        status=status, U_f32=U32, chi2_f32=chi2_32, iterations_f32=it32,
        status_f32=status32,
    )


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:4]))
