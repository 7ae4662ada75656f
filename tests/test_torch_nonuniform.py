"""PyTorch port vs JAX package: config 4 — the non-uniform time-optimal grids
(a free dt per interval) and per-lane stage masks.

- The transcription of config 4 (``tests/test_golden_nonuniform.py:
  _config4_ocp``: double integrator, non-uniform multiple shooting with RK4,
  ``MinimumTime(weight=N, lsq_form=True)``) and of its finite-difference twin:
  residuals, interval Jacobians, objective, gradient, Hessian blocks and pins
  against the reference on the same seeded float64 W (1e-12).
- A per-lane stage mask [B, N] (lanes with different active horizons):
  the same quantities against the reference under ``jax.vmap`` over lanes
  (1e-12), for config 4 and for config 3's single-dt grid with its tie rows;
  with W per lane and with one W shared by the lanes.
- Hoisting is refused under a per-lane mask: ``hoist_structure`` returns
  nothing, ``sqp_solve`` refuses a hoisted J/K, and each lane of a masked
  LTI batch solves as that lane alone (1e-10).
- The golden checks of ``tests/test_golden_nonuniform.py`` through the port
  are in tests/test_torch_nonuniform_golden.py.
- ``benchmark_increasing_n_masked`` and ``benchmark_increasing_n_open_loop``
  against the reference's (objective 1e-8, equal iteration counts).

Every JAX call goes through ``jax.jit`` (see tests/test_torch_ops.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
from control_box_rst_tpu.ocp import (
    Bounds as JaxBounds,
    MinimumTime as JaxMinimumTime,
    non_uniform_fd_variable_grid as jax_nu_fd_grid,
    non_uniform_multiple_shooting_variable_grid as jax_nu_ms_grid,
    transcribe as jax_transcribe,
)
from control_box_rst_tpu.sim import benchmarks as jax_benchmarks
from control_box_rst_tpu.solvers import QPConfig as JaxQPConfig
from control_box_rst_tpu.solvers import SQPConfig as JaxSQPConfig
from control_box_rst_tpu_torch import entry
from control_box_rst_tpu_torch.ocp import Trajectory, stage_mask_from_n
from control_box_rst_tpu_torch.sim import (
    benchmark_increasing_n_masked,
    benchmark_increasing_n_open_loop,
)
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig, sqp_solve
from control_box_rst_tpu_torch.solvers.sqp import hoist_structure

from torch_port_util import jax_flagship, jax_time_optimal, to_np, torch_ocp_like

torch.set_num_threads(1)
TOL = 1e-12
CPU64 = dict(device="cpu", dtype=torch.float64)


def _jax_config4(n, kind="ms"):
    grid = jax_nu_ms_grid(n, integrator="rk4", substeps=1) if kind == "ms" \
        else jax_nu_fd_grid(n, fd_scheme="crank_nicolson")
    return jax_transcribe(
        JaxDI(), grid, JaxMinimumTime(weight=float(n), lsq_form=True),
        bounds=JaxBounds.unbounded(2, 1).with_u(-1.0, 1.0).with_dt(1e-3, 0.5),
        x0=jnp.array([1.5, 0.0]), xf=jnp.zeros(2), xf_fixed=jnp.array([1.0, 1.0]),
    )


def _random_W(seed, lead, N):
    """Stage matrices [*lead, N+1, 4] from a seed, dts in [0.05, 0.3] (stage
    N's dummies 0)."""
    rng = np.random.default_rng(seed)
    W = np.zeros(tuple(lead) + (N + 1, 4))
    W[..., :2] = rng.standard_normal(tuple(lead) + (N + 1, 2))
    W[..., :-1, 2] = rng.uniform(-1.0, 1.0, tuple(lead) + (N,))
    W[..., :-1, 3] = rng.uniform(0.05, 0.3, tuple(lead) + (N,))
    return W


def _evaluations(ocp, W):
    """Everything the solvers take from an OCP at W, port side."""
    J, K, c = ocp.interval_jacobians(W)
    return dict(res=ocp.interval_residuals(W), J=J, K=K, c=c, obj=ocp.objective_from_W(W),
                grad=ocp.cost_gradient(W), H=ocp.cost_hessian_blocks(W))


def _jax_evaluations(ocp_j, W):
    J, K, c = ocp_j.interval_jacobians(W)
    return dict(res=ocp_j.interval_residuals(W), J=J, K=K, c=c, obj=ocp_j.objective_from_W(W),
                grad=ocp_j.cost_gradient(W), H=ocp_j.cost_hessian_blocks(W))


def _assert_same(got, want):
    for key in want:
        np.testing.assert_allclose(to_np(got[key]), np.asarray(want[key]), rtol=0, atol=TOL,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["ms", "fd"])
def test_per_interval_transcription_matches_jax(kind):
    """A free dt per interval: nc = nx (no tie rows), the dt columns free,
    not LTI; residuals, Jacobians and cost terms as the reference's."""
    N = 10
    ocp_j = _jax_config4(N, kind)
    ocp_t = torch_ocp_like(ocp_j, "float64")
    assert (ocp_t.nc, ocp_t.nz, ocp_t.n_tie) == (ocp_j.nc, ocp_j.nz, 0) == (2, 4, 0)
    assert not ocp_t.lti_structure and not ocp_t.per_lane_mask
    np.testing.assert_array_equal(to_np(ocp_t.fixed_mask()), np.asarray(ocp_j.fixed_mask()))
    W = _random_W(0, (), N)
    _assert_same(_evaluations(ocp_t, torch.as_tensor(W)),
                 jax.jit(_jax_evaluations)(ocp_j, jnp.asarray(W)))
    # objective = N·Σ dt_k² (the least-squares form of MinimumTime)
    np.testing.assert_allclose(float(ocp_t.objective_from_W(torch.as_tensor(W))),
                               N * np.sum(W[:-1, 3] ** 2), rtol=1e-14)


@pytest.mark.parametrize("config", ["config4", "config3_single_dt"])
@pytest.mark.parametrize("shared_W", [False, True], ids=["W_per_lane", "W_shared"])
def test_per_lane_mask_matches_jax_vmapped(config, shared_W):
    """Lanes with different active horizons (10, 7, 4, 1, 9 of N = 10) in one
    [B, N] mask: each lane as the reference's lane under ``jax.vmap`` with
    its own [N] mask. Config 3's grid keeps its [N] tie mask under the
    per-lane stage mask."""
    N, n_active = 10, np.array([10, 7, 4, 1, 9])
    B = len(n_active)
    ocp_j = _jax_config4(N) if config == "config4" else jax_time_optimal(N, jnp.float64)[0]
    ocp_t = torch_ocp_like(ocp_j, "float64")
    mask = stage_mask_from_n(torch.as_tensor(n_active), N, torch.float64)
    ocp_m = ocp_t.replace(stage_mask=mask)
    assert ocp_m.per_lane_mask and ocp_m.tie_mask.shape == (N,)
    np.testing.assert_array_equal(to_np(ocp_m.tie_mask), to_np(ocp_t.tie_mask))
    W = _random_W(1, () if shared_W else (B,), N)
    got = _evaluations(ocp_m, torch.as_tensor(W))
    assert got["J"].shape == (B, N, ocp_t.nc, 4) and got["H"].shape == (B, N + 1, 4, 4)

    def one(m, w):
        return _jax_evaluations(ocp_j.replace(stage_mask=m), w)

    want = jax.jit(jax.vmap(one, in_axes=(0, None if shared_W else 0)))(
        jnp.asarray(to_np(mask)), jnp.asarray(W))
    _assert_same(got, want)
    # an inactive interval is an identity chain with a free, cost-free dt
    J, K = to_np(got["J"]), to_np(got["K"])
    np.testing.assert_array_equal(J[3, 5, :2, :2], -np.eye(2))
    np.testing.assert_array_equal(K[3, 5, :2, :2], np.eye(2))
    assert np.all(J[3, 5, :2, 2:] == 0.0) and np.all(to_np(got["H"])[3, 5, 3] == 0.0)


def test_replace_keeps_the_tie_mask_consistent():
    ocp_t = torch_ocp_like(jax_time_optimal(6, jnp.float64)[0], "float64")
    m = stage_mask_from_n(torch.tensor([6, 3]), 6, torch.float64)
    assert ocp_t.replace(stage_mask=m).tie_mask is ocp_t.tie_mask
    o32 = ocp_t.replace(stage_mask=m.float())
    assert o32.tie_mask.dtype == torch.float32
    np.testing.assert_array_equal(to_np(o32.tie_mask), [1, 1, 1, 1, 1, 0])
    assert ocp_t.to(dtype=torch.float32).replace(stage_mask=m.float()).tie_mask.dtype == torch.float32


def test_hoisting_is_refused_under_a_per_lane_mask():
    """Config 1 is LTI: one J/K/Hd for every lane, unless the lanes have
    their own horizons. Then nothing is hoisted, a hoisted structure is
    refused, and each lane of the masked batch is that lane solved alone."""
    N = 8
    ocp_j, _ = jax_flagship(N, jnp.float64)
    ocp_t = torch_ocp_like(ocp_j, "float64")
    cfg = SQPConfig(max_iter=10, qp=QPConfig(max_iter=400, iters_per_round=50, tol=1e-10),
                    tol_stat=1e-8, tol_feas=1e-9)
    n_active = torch.tensor([8, 5, 3])
    x0s = torch.tensor([[1.0, 0.0], [-0.5, 0.8], [0.3, -0.6]], dtype=torch.float64)
    traj0 = Trajectory.linear_interp(x0s, torch.zeros(2, dtype=torch.float64), N, 1, 0.1)
    shared = hoist_structure(ocp_t, traj0, cfg)
    assert shared.Jm is not None and shared.Jm.dim() == 3
    masked = ocp_t.replace(stage_mask=stage_mask_from_n(n_active, N, torch.float64),
                           bc=ocp_t.bc.replace(x0=x0s))
    assert hoist_structure(masked, traj0, cfg) == (None, None, None)
    with pytest.raises(ValueError, match="per-lane stage mask"):
        sqp_solve(masked, traj0, cfg, hoisted=shared)
    res = sqp_solve(masked, traj0, cfg)
    for b in range(3):
        alone = ocp_t.replace(stage_mask=stage_mask_from_n(int(n_active[b]), N, torch.float64),
                              bc=ocp_t.bc.replace(x0=x0s[b]))
        r1 = sqp_solve(alone, Trajectory.linear_interp(x0s[b], torch.zeros(2, dtype=torch.float64),
                                                         N, 1, 0.1), cfg)
        np.testing.assert_allclose(to_np(res.W[b]), to_np(r1.W), rtol=0, atol=1e-10)
        assert int(res.iterations[b]) == int(r1.iterations)
    # lanes did get different horizons: the inactive tail holds the final state
    X = to_np(res.W)[2, :, :2]
    np.testing.assert_allclose(X[3:], np.repeat(X[3:4], N - 2, axis=0), atol=1e-9)


def _bench_cfgs():
    """Config 4's own settings (``entry.nonuniform_ms_timeopt``) on both
    sides."""
    kw = dict(max_iter=25, tol_stat=3e-4, tol_feas=1e-5)
    return (JaxSQPConfig(qp=JaxQPConfig(max_iter=80, iters_per_round=40, tol=1e-5), **kw),
            SQPConfig(qp=QPConfig(max_iter=80, iters_per_round=40, tol=1e-5), **kw))


def test_benchmark_increasing_n_masked_matches_jax():
    """One batch, lane i with the active horizon N_values[i] of the N = 10
    config-4 grid: objective, iterations and feasibility of every lane as the
    reference's vmapped sweep."""
    ocp_j = _jax_config4(10)
    cfg_j, cfg_t = _bench_cfgs()
    n_values = [10, 8, 6, 5]
    want = jax_benchmarks.benchmark_increasing_n_masked(ocp_j, n_values, jnp.array([1.5, 0.0]), 0.1, cfg_j)
    got = benchmark_increasing_n_masked(torch_ocp_like(ocp_j, "float64"), n_values,
                                        np.array([1.5, 0.0]), 0.1, cfg_t, **CPU64)
    assert [r["N"] for r in got] == n_values
    for g, w in zip(got, want):
        assert g["iterations"] == w["iterations"], (g, w)
        assert abs(g["objective"] - w["objective"]) < 1e-8, (g, w)
        assert abs(g["feas_res"] - w["feas_res"]) < 1e-8 and g["solve_time_s"] > 0.0
    # a shorter active horizon needs larger dts: the objective N_max·Σ dt²
    # grows as the horizon shrinks
    objs = [r["objective"] for r in got]
    assert objs == sorted(objs)


def test_benchmark_increasing_n_open_loop_matches_jax():
    cfg_j, cfg_t = _bench_cfgs()
    n_values = [6, 10]
    want = jax_benchmarks.benchmark_increasing_n_open_loop(
        _jax_config4, n_values, jnp.array([1.5, 0.0]), 0.1, cfg_j)
    got = benchmark_increasing_n_open_loop(
        lambda n: entry.nonuniform_ms_timeopt(n, **CPU64)[0], n_values, np.array([1.5, 0.0]),
        0.1, cfg_t, **CPU64)
    for g, w in zip(got, want):
        assert (g["N"], g["iterations"], g["status"]) == (w["N"], w["iterations"], w["status"])
        assert abs(g["objective"] - w["objective"]) < 1e-8
