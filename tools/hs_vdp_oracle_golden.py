"""Golden file of config 6 (Van der Pol, Hermite-Simpson defects with the
Simpson cost, H=20): the JAX package's float64 oracle on the first lanes of
the batch that ``chip_smoke.py`` solves.

Usage:  JAX_PLATFORMS=cpu python tools/hs_vdp_oracle_golden.py OUT.npz [n_lanes]

Config 6 is ``examples/config6_hermite_simpson.yaml``: Van der Pol on
``finite_differences_grid(20, 'hermite_simpson', cost_integration=
'hermite_simpson')``, Q = I, R = 0.1 integral, Qf = 5·I, |u| <= 2, dt 0.1.
The YAML's ``integral: true`` is applied to the whole composite cost, as the
port's ``entry.hermite_simpson`` builds it (the JAX package's YAML loader
builds the composite without it, which turns the Simpson rule off; see
ROADMAP queue 3).

  OUT.npz: x0s [n, 2] float32 — the first ``n_lanes`` (default 48) of
           numpy ``default_rng(60).uniform(-1.5, 1.5)`` over 4096 lanes, lane 0
           replaced by the YAML's x0 = [1, 0.5];
           U [n, 20, 1] float64, obj [n], converged [n] — the compressed
           grid's solve; U_unc, obj_unc, converged_unc — the same OCP on
           the uncompressed grid (``hermite_simpson_uncompressed_grid``):
           SQP with the non-fused ADMM at tight tolerances (float64, from
           the straight line to the origin, dt 0.1), the JAX package
           unmodified, under ``jax.jit(jax.vmap(...))`` on the CPU.

``tests/golden/torch_hs_vdp_oracle_N20.npz`` is this tool's output for the
defaults.
"""
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

BATCH = 4096
N = 20


def initial_states(n_lanes: int = BATCH) -> np.ndarray:
    """The batch of ``chip_smoke.py``'s config-6 phases: x0 ~ U(-1.5, 1.5)²
    from ``default_rng(60)``, lane 0 at the YAML's [1, 0.5]; float32."""
    x0s = np.random.default_rng(60).uniform(-1.5, 1.5, size=(BATCH, 2)).astype(np.float32)
    x0s[0] = [1.0, 0.5]
    return x0s[:n_lanes]


def jax_config6_ocp(grid: str = "hs", dtype=None):
    """Config 6's OCP built with the JAX package: ``grid`` 'hs' (compressed)
    or 'unc' (uncompressed Hermite-Simpson), every floating array as
    ``dtype`` (the default dtype when None)."""
    import jax
    import jax.numpy as jnp

    from control_box_rst_tpu.models import VanDerPolOscillator
    from control_box_rst_tpu.ocp import (
        Bounds,
        CompositeCost,
        QuadraticFinalStateCost,
        QuadraticFormCost,
        finite_differences_grid,
        hermite_simpson_uncompressed_grid,
        transcribe,
    )

    g = (finite_differences_grid(N, fd_scheme="hermite_simpson",
                                 cost_integration="hermite_simpson")
         if grid == "hs" else hermite_simpson_uncompressed_grid(N))
    cost = CompositeCost(costs=(
        QuadraticFormCost(Q=jnp.eye(2), R=0.1 * jnp.eye(1), integral=True),
        QuadraticFinalStateCost(Qf=5.0 * jnp.eye(2)),
    ), integral=True)
    ocp = transcribe(VanDerPolOscillator(), g, cost,
                     bounds=Bounds.unbounded(2, 1).with_u(-2.0, 2.0).with_dt(0.1, 0.1),
                     x0=jnp.array([1.0, 0.5]))
    if dtype is None:
        return ocp
    return jax.tree.map(
        lambda a: a.astype(dtype)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a, ocp)


def oracle(x0s: np.ndarray, grid: str):
    """Float64 SQP solves of config 6 from the straight line: (U, obj,
    converged)."""
    import jax
    import jax.numpy as jnp

    from control_box_rst_tpu.ocp.problem import Trajectory
    from control_box_rst_tpu.solvers import QPConfig, SQPConfig
    from control_box_rst_tpu.solvers.sqp import sqp_solve

    ocp = jax_config6_ocp(grid, jnp.float64)
    cfg = SQPConfig(
        max_iter=50,
        qp=QPConfig(max_iter=4000, iters_per_round=100, rho=1.0, tol=1e-10, backend="xla"),
        tol_stat=1e-8, tol_feas=1e-9,
    )

    def solve_one(x0):
        o = ocp.replace(bc=ocp.bc.replace(x0=x0))
        traj0 = Trajectory.linear_interp(x0, jnp.zeros(2), N, 1, 0.1)
        res = sqp_solve(o, traj0, cfg)
        return res.traj.U, res.objective, res.status

    U, obj, status = jax.jit(jax.vmap(solve_one))(jnp.asarray(x0s, jnp.float64))
    return np.asarray(U), np.asarray(obj), np.asarray(status == 1)


def main(out_path: str, n_lanes: int = 48) -> None:
    x0s = initial_states(n_lanes)
    U, obj, conv = oracle(x0s, "hs")
    U_unc, obj_unc, conv_unc = oracle(x0s, "unc")
    print(f"converged {conv.mean()} / {conv_unc.mean()}, "
          f"max |U_unc - U| {np.abs(U_unc - U).max():.3e}")
    np.savez(out_path, x0s=x0s, U=U, obj=obj, converged=conv,
             U_unc=U_unc, obj_unc=obj_unc, converged_unc=conv_unc)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)
    main(sys.argv[1], *(int(a) for a in sys.argv[2:3]))
