"""PyTorch port vs JAX package: the Levenberg-Marquardt solver.

The same OCPs go through ``control_box_rst_tpu.solvers.lm_solve`` and the
port's batched ``lm_solve``: the N=15 forward-Euler least-squares problems of
tests/test_lm_solver.py (unbounded and |u| <= 0.5) and the config-1 OCP at
N=12 and N=50, four lanes each, built on the port's side from numpy
(``convert.ocp_from_numpy``).

The JAX side solves ONE LANE PER CALL, as ``jax.jit(jax.vmap(lm_solve))``
over a batch of one. It is not vmapped over the lanes: on this CPU backend
``jax.vmap(lm_solve)`` over several lanes gives lane-dependent answers (four
identical initial states come back as three different trajectories after one
iteration), and the un-vmapped ``jax.jit(lm_solve)`` has been seen to abort
the process (``free(): invalid pointer``); the batch-of-one form is
reproducible and is what the port reproduces to rounding. The float32
reference runs inside ``jax.enable_x64(False)``: with x64 on, the empty default residual of the
cost base class is float64 and the reference's float32 LM does not trace.

What is compared, and how tightly:
  - float64, after k = 1..8 iterations (``max_iter=k``): W to 1e-7, χ² to
    1e-7 relative — every decision of the loop (accept, μ, ν, stall, weight
    growth) has been taken identically up to there; the first iterates agree
    to 1e-13, and the penalty weights (×10 per stall) amplify the rounding
    of the linear solve from then on;
  - float64, full solve: U to 1e-6, χ² to 1e-8, status equal; the iteration
    count within ±3 (the stall test compares χ² differences with 1e-10 and
    flips on rounding when the last steps are at that level);
  - float32: after one iteration W to 1e-4. For the full solve a
    lane-by-lane tolerance is not meaningful: the accept test ``actual > 0``
    and the stall test sit below float32 resolution near the solution, a
    rejected step counts as a stall, and a stall at an infeasible point
    multiplies the penalty weights by 10, so two correct float32
    implementations end with different weights on some lanes and their U
    differ by up to 1e-2 (the reference's own float32 solve is up to 0.46
    from its float64 solve on the 64 lanes of the golden file). Held
    instead: status equal, and the port's float32 answer as close to the
    float64 reference as the reference's float32 answer is (max over lanes,
    slack 3x + 2e-4), for U and for χ²; iterations within ±20.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.models import DoubleIntegratorContinuous
from control_box_rst_tpu.ocp import (
    Bounds,
    QuadraticFormCost,
    finite_differences_grid,
    transcribe,
)
from control_box_rst_tpu.ocp.problem import Trajectory as JaxTrajectory
from control_box_rst_tpu.solvers import LMConfig as JaxLMConfig
from control_box_rst_tpu.solvers import lm_solve as jax_lm_solve
from control_box_rst_tpu_torch import convert
from control_box_rst_tpu_torch.entry import flagship_lm
from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.parallel import make_batched_lm_solver
from control_box_rst_tpu_torch.solvers import LMConfig, lm_solve
from control_box_rst_tpu_torch.solvers.lm import LMProblem

from torch_port_util import TORCH_DTYPES, jax_flagship, spec_from_jax_ocp, to_np

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_lm_oracle_N50.npz"

_X0_FLAGSHIP = np.random.default_rng(0).uniform(-1.0, 1.0, size=(32768, 2)).astype(np.float32)[:4]
_X0_LSQ = np.array([[1.0, 0.0], [-0.5, 0.2], [0.3, -0.8], [2.0, 1.0]], np.float32)
# name -> (N, max_iter, initial states)
PROBLEMS = {
    "lsq_unbounded": (15, 60, _X0_LSQ),
    "lsq_u_max_0.5": (15, 80, _X0_LSQ),
    "flagship_N12": (12, 60, _X0_FLAGSHIP),
    "flagship_N50": (50, 60, _X0_FLAGSHIP),
}


def _jax_ocp(name, dtype):
    """The JAX OCP, built under the x64 mode that is active (so float32 means
    float32 throughout)."""
    N = PROBLEMS[name][0]
    if name.startswith("flagship"):
        return jax_flagship(N, dtype)[0]
    cost = QuadraticFormCost(
        Q=jnp.diag(jnp.array([1.0, 0.5])), R=0.1 * jnp.eye(1), lsq_form=True)
    bounds = Bounds.unbounded(2, 1)
    if name == "lsq_u_max_0.5":
        bounds = bounds.with_u(-0.5, 0.5)
    return transcribe(
        DoubleIntegratorContinuous(), finite_differences_grid(N, fd_scheme="forward"),
        cost, bounds=bounds, x0=jnp.array([1.0, 0.0]))


def _x64(dtype_name):
    return jax.enable_x64(dtype_name == "float64")


def _jax_solve(name, dtype_name, max_iter=None):
    """Per-lane reference solves → (ocp, W, chi2, iterations, feas, status),
    arrays stacked over the problem's lanes."""
    N, default_iter, x0s = PROBLEMS[name]
    np_dtype = np.dtype(dtype_name)
    with _x64(dtype_name):
        ocp = _jax_ocp(name, np_dtype)
        cfg = JaxLMConfig(max_iter=max_iter or default_iter)

        def solve_one(x0):
            o = ocp.replace(bc=ocp.bc.replace(x0=x0))
            traj0 = JaxTrajectory.linear_interp(x0, jnp.zeros(2, np_dtype), N, 1, 0.1)
            r = jax_lm_solve(o, traj0, cfg)
            return r.W, r.chi2, r.iterations, r.feas_res, r.status

        solve = jax.jit(jax.vmap(solve_one))  # over a batch of one lane
        outs = [[np.asarray(a)[0] for a in solve(x0[None].astype(np_dtype))] for x0 in x0s]
        spec = spec_from_jax_ocp(ocp)
    assert outs[0][0].dtype == np_dtype
    return (spec,) + tuple(np.stack([o[i] for o in outs]) for i in range(5))


def _torch_solve(spec, name, dtype_name, max_iter=None, x0s=None):
    N, default_iter, x0_all = PROBLEMS[name]
    dtype = TORCH_DTYPES[dtype_name]
    ocp = convert.ocp_from_numpy(spec, dtype=dtype, device="cpu")
    x0 = torch.as_tensor(x0_all if x0s is None else x0s).to(dtype)
    o = ocp.replace(bc=ocp.bc.replace(x0=x0))
    traj0 = Trajectory.linear_interp(x0, torch.zeros(2, dtype=dtype), N, 1, 0.1)
    return lm_solve(o, traj0, LMConfig(max_iter=max_iter or default_iter))


@pytest.fixture(scope="module")
def reference():
    """Full reference solves, made once per (problem, dtype)."""
    cache = {}

    def get(name, dtype_name):
        if (name, dtype_name) not in cache:
            cache[name, dtype_name] = _jax_solve(name, dtype_name)
        return cache[name, dtype_name]

    return get


# --------------------------------------------------------------------------
# parts
# --------------------------------------------------------------------------

def _problem_and_point(name="flagship_N12", B=3):
    """An LMProblem in float64 and a W with bound violations, at given
    per-lane penalty weights."""
    spec = _jax_solve(name, "float64", max_iter=1)[0]
    ocp = convert.ocp_from_numpy(spec, dtype=torch.float64, device="cpu")
    prob = LMProblem(ocp, LMConfig(), torch.float64)
    rng = np.random.default_rng(4)
    W = torch.from_numpy(rng.standard_normal((B, ocp.N + 1, ocp.nz)))
    W[..., ocp.nx] *= 1.5          # some controls beyond |u| <= 1
    W[..., -1] = 0.1               # dt pinned
    w_eq = torch.tensor([2.0, 20.0, 2000.0], dtype=torch.float64)[:B]
    w_b = torch.tensor([2.0, 200.0, 20.0], dtype=torch.float64)[:B]
    w_ineq = torch.full_like(w_b, prob.cfg.weight_ineq)
    return prob, W, w_eq, w_b, w_ineq


def test_gn_system_is_the_normal_equations_of_the_stacked_residual():
    """D, O, g against JᵀJ and Jᵀr of the whole residual vector, whose
    Jacobian comes from reverse-mode AD of ``all_residuals`` (1e-10): the
    block assembly, the masking of pinned columns and the hinge derivatives."""
    from control_box_rst_tpu_torch.ops.btridiag import btridiag_dense

    prob, W, w_eq, w_b, w_ineq = _problem_and_point()
    D, O, g, chi2 = prob.gn_system(W, w_eq, w_b, w_ineq)
    n = W.shape[1] * W.shape[2]
    for i in range(W.shape[0]):
        def stacked(w):
            r_int, r_term = prob.all_residuals(
                w[None], w_eq[i:i + 1], w_b[i:i + 1], w_ineq[i:i + 1])
            return torch.cat([r_int.reshape(-1), r_term.reshape(-1)])

        r = stacked(W[i])
        Jac = torch.autograd.functional.jacobian(stacked, W[i]).reshape(r.numel(), n)
        Jac = Jac * prob.free.reshape(1, n)
        np.testing.assert_allclose(
            to_np(btridiag_dense(D[i], O[i])), to_np(Jac.T @ Jac), rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(
            to_np(g[i].reshape(-1)), to_np(Jac.T @ r), rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(float(chi2[i]), float(r @ r), rtol=1e-13)
    assert float((W[..., prob.ocp.nx].abs() > 1).float().mean()) > 0.1  # hinges active


def test_residual_layout_and_chi2():
    prob, W, w_eq, w_b, w_ineq = _problem_and_point()
    ocp = prob.ocp
    r_int, r_term = prob.all_residuals(W, w_eq, w_b, w_ineq)
    assert prob.n_lsq == 3 and prob.nr == 3 + ocp.nc + ocp.nz
    assert r_int.shape == (3, ocp.N, prob.nr) and r_term.shape == (3, prob.nr)
    # terminal block: padded terminal-cost residual, no equality rows
    assert bool((r_term[:, 2:3 + ocp.nc] == 0).all())
    c = ocp.interval_residuals(W)
    np.testing.assert_allclose(
        to_np(r_int[..., 3:3 + ocp.nc]), to_np(torch.sqrt(w_eq)[:, None, None] * c), rtol=1e-14)
    # pinned entries (x_0, dt) contribute no box rows
    assert bool((r_int[:, 0, 3 + ocp.nc:3 + ocp.nc + ocp.nx] == 0).all())
    assert bool((r_int[..., -1] == 0).all())
    np.testing.assert_allclose(
        to_np(prob.chi2_of(W, w_eq, w_b, w_ineq)),
        to_np((r_int ** 2).sum((1, 2)) + (r_term ** 2).sum(1)), rtol=1e-14)


def test_general_rows_are_refused():
    """General rows were refused here until the constrained slice; now the
    LM problem takes them: every residual block grows by ng hinge rows
    (tests/test_torch_general_rows.py holds their values against the JAX
    LM), and a problem without them keeps its rows."""
    from control_box_rst_tpu_torch import entry

    prob, *_ = _problem_and_point()
    di = entry.constrained_di(dtype=torch.float64, device="cpu")[0]
    with_rows = LMProblem(di, LMConfig(), torch.float64)
    assert with_rows.ng == 2 == di.ng and prob.ng == 0
    assert with_rows.nr == with_rows.n_lsq + di.nc + 2 + di.nz
    assert prob.nr == prob.n_lsq + prob.ocp.nc + prob.ocp.nz


# --------------------------------------------------------------------------
# the iteration, step by step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("name", ["lsq_u_max_0.5", "flagship_N12"])
def test_iterates_match_jax_f64(name, k):
    spec, W_j, chi2_j, it_j, feas_j, _ = _jax_solve(name, "float64", max_iter=k)
    r = _torch_solve(spec, name, "float64", max_iter=k)
    assert r.W.dtype == torch.float64 and r.iterations.dtype == torch.int32
    np.testing.assert_array_equal(to_np(r.iterations), it_j)
    np.testing.assert_allclose(to_np(r.W), W_j, rtol=0, atol=1e-12 if k == 1 else 1e-7)
    finite = np.isfinite(chi2_j)  # inf: the weights grew in the last iteration
    np.testing.assert_array_equal(np.isfinite(to_np(r.chi2)), finite)
    np.testing.assert_allclose(to_np(r.chi2)[finite], chi2_j[finite], rtol=1e-7)
    np.testing.assert_allclose(to_np(r.feas_res), feas_j, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", ["lsq_u_max_0.5", "flagship_N12"])
def test_first_iterate_matches_jax_f32(name):
    spec, W_j, chi2_j, it_j, _, _ = _jax_solve(name, "float32", max_iter=1)
    r = _torch_solve(spec, name, "float32", max_iter=1)
    assert r.W.dtype == torch.float32
    np.testing.assert_array_equal(to_np(r.iterations), it_j)
    np.testing.assert_allclose(to_np(r.W), W_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_np(r.chi2), chi2_j, rtol=1e-4)


# --------------------------------------------------------------------------
# full solves
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solve_matches_jax_f64(name, reference):
    spec, W_j, chi2_j, it_j, feas_j, status_j = reference(name, "float64")
    r = _torch_solve(spec, name, "float64")
    nx = spec["nx"]
    np.testing.assert_array_equal(to_np(r.status), status_j)
    assert r.status.dtype == torch.int32 and bool((r.status == 1).all())
    np.testing.assert_allclose(to_np(r.traj.U), W_j[:, :-1, nx:nx + 1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(r.traj.X), W_j[..., :nx], rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(r.chi2), chi2_j, rtol=1e-8)
    assert np.abs(to_np(r.iterations).astype(int) - it_j.astype(int)).max() <= 3
    assert float(r.feas_res.max()) < 1e-6
    if name == "lsq_u_max_0.5":  # penalty method: small overshoot allowed
        assert 0.499 < float(r.traj.U.abs().max()) < 0.5 + 1e-3


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solve_f32_is_as_close_to_f64_as_the_reference_f32(name, reference):
    spec, W64, chi64, *_ = reference(name, "float64")
    _, W32, chi32, it32, _, status32 = reference(name, "float32")
    r = _torch_solve(spec, name, "float32")
    nx = spec["nx"]
    assert r.W.dtype == torch.float32
    np.testing.assert_array_equal(to_np(r.status), status32)
    U64 = W64[:, :-1, nx:nx + 1]
    e_ref = np.abs(W32[:, :-1, nx:nx + 1] - U64).max()
    e_port = np.abs(to_np(r.traj.U) - U64).max()
    assert e_port <= 3.0 * e_ref + 2e-4, (e_port, e_ref)
    # χ² is inf on a lane whose weights grew in its last iteration (a lane
    # that ran out of iterations): compare where both sides report a value
    both = np.isfinite(chi32) & np.isfinite(to_np(r.chi2))
    assert both.sum() >= len(both) - 1
    c_ref = (np.abs(chi32 - chi64) / (1.0 + chi64))[both].max()
    c_port = (np.abs(to_np(r.chi2) - chi64) / (1.0 + chi64))[both].max()
    assert c_port <= 3.0 * c_ref + 2e-4, (c_port, c_ref)
    assert np.abs(to_np(r.iterations).astype(int) - it32.astype(int)).max() <= 20
    assert float(r.feas_res.max()) < 1e-4


def test_a_lane_of_a_batch_equals_its_single_solve(reference):
    """Lane freezing: a finished lane keeps its whole state (iteration
    counter included) while the others go on, so a lane's result does not
    depend on its neighbours. Exact: the same arithmetic per lane."""
    name = "flagship_N12"
    spec = reference(name, "float64")[0]
    batch = _torch_solve(spec, name, "float64")
    assert len(set(to_np(batch.iterations).tolist())) > 1, "lanes should finish at different times"
    for i in (0, 3):
        one = _torch_solve(spec, name, "float64", x0s=PROBLEMS[name][2][i:i + 1])
        assert torch.equal(one.W[0], batch.W[i])
        assert int(one.iterations[0]) == int(batch.iterations[i])
        assert float(one.chi2[0]) == float(batch.chi2[i])
    # an unbatched problem is a batch of one with the lead dims dropped
    solo = _torch_solve(spec, name, "float64", x0s=PROBLEMS[name][2][3])
    assert solo.W.shape == batch.W.shape[1:] and solo.iterations.shape == ()
    assert torch.equal(solo.W, batch.W[3])


def test_iteration_budget_gives_early_terminated():
    name = "flagship_N12"
    spec, _, _, it_j, _, status_j = _jax_solve(name, "float64", max_iter=4)
    r = _torch_solve(spec, name, "float64", max_iter=4)
    assert bool((r.iterations == 4).all()) and (it_j == 4).all()
    np.testing.assert_array_equal(to_np(r.status), status_j)
    assert bool((r.status == 2).all())


# --------------------------------------------------------------------------
# through the entry points, against the golden file
# --------------------------------------------------------------------------

def test_golden_file_is_the_benchmarks_inputs():
    gold = np.load(GOLDEN)
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-1.0, 1.0, size=(32768, 2)).astype(np.float32)
    np.testing.assert_array_equal(gold["x0s"], x0s[:64])
    assert gold["U"].shape == (64, 50, 1) and gold["U"].dtype == np.float64
    assert gold["U_f32"].shape == (64, 50, 1) and gold["U_f32"].dtype == np.float32
    assert (gold["status"] == 1).all() and (gold["status_f32"] == 1).all()
    assert np.isfinite(gold["chi2"]).all() and gold["feas_res"].max() < 1e-6
    assert np.abs(gold["U"]).max() <= 1.0 + 1e-5


def test_batched_lm_solver_f64_matches_golden():
    gold = np.load(GOLDEN)
    lanes = [0, 1, 2, 3]
    ocp, cfg = flagship_lm(N=50, dtype=torch.float64, device="cpu")
    assert cfg.max_iter == 60
    solver = make_batched_lm_solver(ocp, cfg, dt_init=0.1, device="cpu", dtype=torch.float64)
    U, chi2, status, iters, feas = solver(gold["x0s"][lanes].astype(np.float64))
    assert U.dtype == torch.float64 and U.shape == (4, 50, 1)
    assert bool((status == 1).all())
    assert float(np.abs(to_np(U) - gold["U"][lanes]).max()) <= 1e-6
    np.testing.assert_allclose(to_np(chi2), gold["chi2"][lanes], rtol=1e-8)
    assert np.abs(to_np(iters) - gold["iterations"][lanes]).max() <= 3
    # which kernel the card would use does not change the CPU answer
    U3, *_ = make_batched_lm_solver(
        ocp, cfg, device="cpu", dtype=torch.float64, inplace=False)(gold["x0s"][lanes])
    assert torch.equal(U3, U)


def test_forward_euler_ocp_crosses_from_numpy():
    """``fd_scheme="forward"`` and a bare least-squares stage cost carried by
    ``convert.ocp_from_numpy``: same defects and the same residual widths."""
    with _x64("float64"):
        ocp_j = _jax_ocp("lsq_unbounded", np.float64)
        spec = spec_from_jax_ocp(ocp_j)
        rng = np.random.default_rng(2)
        X, U = rng.standard_normal((16, 2)), rng.standard_normal((15, 1))
        traj_j = JaxTrajectory(X=jnp.asarray(X), U=jnp.asarray(U), dts=jnp.full((15,), 0.1))
        want = np.asarray(jax.jit(ocp_j.defects)(traj_j))
    assert spec["fd_scheme"] == "forward" and spec["lsq_form"] and spec["Qf"] is None
    ocp_t = convert.ocp_from_numpy(spec, dtype=torch.float64, device="cpu")
    assert ocp_t.cost.costs[0].lsq_form and len(ocp_t.cost.costs) == 1
    traj_t = Trajectory(
        X=torch.from_numpy(X), U=torch.from_numpy(U),
        dts=torch.full((15,), 0.1, dtype=torch.float64))
    np.testing.assert_allclose(to_np(ocp_t.defects(traj_t)), want, rtol=0, atol=1e-12)
    prob = LMProblem(ocp_t, LMConfig(), torch.float64)
    assert prob.n_lsq == 3 and prob.nr == 3 + 2 + 4
