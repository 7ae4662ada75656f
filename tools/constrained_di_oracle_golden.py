"""Golden file of the constrained double integrator (``entry.constrained_di``):
the JAX package's float64 SQP solution of the first lanes of the batch that
``chip_smoke.py`` solves.

Usage:  JAX_PLATFORMS=cpu python tools/constrained_di_oracle_golden.py OUT.npz [n_lanes]

The OCP is the one of ``tests/test_ip_solver.py:37-51,73-92``: the double
integrator on ``finite_differences_grid(N=25)`` (Crank–Nicolson, dt 0.25
pinned), Q = I, R = 0.1, no terminal cost, |u| <= 1, the stage row
x2 >= -0.9 and the terminal equality x_N = 0. The batch: x0 = [d, 0] with
d ~ U(-2, 2) from ``numpy.random.default_rng(6)`` over 4096 lanes, lane 0 at
d = 2.0 (the test's own x0). Each lane is solved by
``jax.jit(jax.vmap(sqp_solve))`` in float64 at the tight tolerances of
``tools/oracle_solve.py`` (non-fused ADMM to 1e-10, KKT to 1e-8 / 1e-9)
from the straight line to 0 with dt 0.25; the tool also reports how far
the float64 interior-point solve (tol 1e-10) lands from it.

  OUT.npz: x0s [n, 2] float32; U [n, 25, 1], X [n, 26, 2], obj [n] float64;
           converged [n] bool, iterations [n].

``tests/golden/torch_constrained_di_oracle_N25.npz`` is this tool's output
for the defaults (64 lanes).
"""
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from control_box_rst_tpu.models import DoubleIntegratorContinuous  # noqa: E402
from control_box_rst_tpu.ocp import (  # noqa: E402
    Bounds,
    QuadraticFormCost,
    Trajectory,
    finite_differences_grid,
    transcribe,
)
from control_box_rst_tpu.ocp.constraints import (  # noqa: E402
    FunctionalStageConstraint,
    terminal_equality,
)
from control_box_rst_tpu.solvers import IPConfig, QPConfig, SQPConfig, ip_solve, sqp_solve  # noqa: E402

BATCH = 4096
N = 25
DT = 0.25


def constrained_di_x0s(n: int = BATCH) -> np.ndarray:
    """The batch's initial states: [d, 0], d ~ U(-2, 2), lane 0 at d = 2."""
    d = np.random.default_rng(6).uniform(-2.0, 2.0, size=BATCH)
    d[0] = 2.0
    return np.stack([d, np.zeros(BATCH)], axis=1).astype(np.float32)[:n]


def constrained_di_ocp():
    """The JAX package's OCP (dtype of the x64 mode that is active)."""
    sc = FunctionalStageConstraint(nineq=1, ineq_fn=lambda x, u: -x[1] - 0.9)
    return transcribe(
        DoubleIntegratorContinuous(), finite_differences_grid(N=N),
        QuadraticFormCost(Q=jnp.eye(2), R=0.1 * jnp.eye(1)),
        bounds=Bounds.unbounded(2, 1).with_u(-1.0, 1.0),
        x0=jnp.array([2.0, 0.0]), stage_con=sc, term_con=terminal_equality(2),
    )


def main(out_path: str, n_lanes: int = 64) -> None:
    x0s = constrained_di_x0s(n_lanes)
    ocp = constrained_di_ocp()
    cfg = SQPConfig(
        max_iter=50,
        qp=QPConfig(max_iter=4000, iters_per_round=100, tol=1e-10),
        tol_stat=1e-8, tol_feas=1e-9,
    )

    def solve_one(x0):
        o = ocp.replace(bc=ocp.bc.replace(x0=x0))
        r = sqp_solve(o, Trajectory.linear_interp(x0, jnp.zeros(2), N, 1, DT), cfg)
        return r.traj.U, r.traj.X, r.objective, r.status, r.iterations

    U, X, obj, status, iters = jax.jit(jax.vmap(solve_one))(jnp.asarray(x0s, jnp.float64))
    def ip_one(x0):
        o = ocp.replace(bc=ocp.bc.replace(x0=x0))
        r = ip_solve(o, Trajectory.linear_interp(x0, jnp.zeros(2), N, 1, DT),
                     IPConfig(tol=1e-10, max_iter=200))
        return r.traj.U, r.status

    U_ip, st_ip = jax.jit(jax.vmap(ip_one))(jnp.asarray(x0s, jnp.float64))
    print(f"float64 IP (tol 1e-10): converged {int((np.asarray(st_ip) == 1).sum())}, "
          f"max |U_ip - U_sqp| {float(np.abs(np.asarray(U_ip) - np.asarray(U)).max()):.3e}")
    np.savez(out_path, x0s=x0s, U=np.asarray(U), X=np.asarray(X), obj=np.asarray(obj),
             converged=np.asarray(status) == 1, iterations=np.asarray(iters))
    print(f"{n_lanes} lanes: converged {int((np.asarray(status) == 1).sum())}, "
          f"iterations max {int(np.asarray(iters).max())}, "
          f"min x2 {float(np.asarray(X)[..., 1].min()):.6f}, "
          f"max |x_N| {float(np.abs(np.asarray(X)[:, -1]).max()):.3e}")


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    main(sys.argv[1], *(int(a) for a in sys.argv[2:3]))
