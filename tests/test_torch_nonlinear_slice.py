"""PyTorch port vs JAX package: the nonlinear SQP paths of configs 2 and 3.

Config 2 (``entry.vdp_ms``: Van der Pol, multiple shooting with RK4) and
config 3 (``entry.time_optimal``: the double integrator on the time-optimal
grid, one dt tied across the intervals, ``MinimumTime``) at N=8, through the
port's ``make_batched_solver(device="cpu")`` in float32 with the fused
backend (on the CPU the plain version stands behind the kernel's wrapper),
against the JAX ``sqp_solve`` called UNBATCHED per lane under ``jax.jit``
(there ``custom_vmap`` takes the per-lane reference ``_reference``, the
semantics the port's kernel follows). Neither problem is LTI: every lane takes
the outer SQP loop, and the QP of every iteration is solved with Hd, J, K of
its own lane.

The JAX side runs with x64 off (``jax.enable_x64(False)``): with x64 on, the
float64 tableau coefficients of the integrator turn the float32 problem into
float64 in places and the fused branch no longer traces.

Tolerances of the float32 comparison: U atol 2e-4, objective rtol 1e-4,
status equal. The SQP iteration count is compared per lane with one
allowance: both sides stop at tol_stat 1e-4 (config 2) / 3e-4 (config 3),
near the float32 ADMM dual floor, so a lane whose residual sits at a
tolerance can take one iteration more or fewer on one side. Every lane is
held to |Δiterations| <= 1 and at least 80 % of the lanes to equality; on
these lanes the counts were equal on all 8 of each config, U within 2e-5.

The float64 checks (``backend='plain'``, the oracle's own settings, KKT
tolerances 1e-8 / 1e-9, QP tolerance 1e-10): config 3's total time equals
the analytic optimum T* = 2√d to 1e-6 (Crank–Nicolson reproduces it
exactly), and config 2 matches the float64 oracle golden file
``tests/golden/torch_vdp_ms_oracle_N20.npz`` (``tools/vdp_ms_oracle_golden.py``)
to 1e-6 on 3 lanes at N=20.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.ocp.problem import Trajectory as JaxTrajectory
from control_box_rst_tpu.solvers.sqp import sqp_solve as jax_sqp_solve
from control_box_rst_tpu_torch import entry
from control_box_rst_tpu_torch.ops.cuda import admm_kernel
from control_box_rst_tpu_torch.parallel import make_batched_solver
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

from torch_port_util import jax_time_optimal, jax_vdp_ms, to_np

torch.set_num_threads(1)
N = 8
GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_vdp_ms_oracle_N20.npz"
BATCH = 4096  # the batch chip_smoke.py solves; the tests take its first lanes
CONFIGS = {
    # name: (port entry, JAX builder, initial dt of the straight-line guess)
    "vdp_ms": (entry.vdp_ms, jax_vdp_ms, 0.1),
    "time_optimal": (entry.time_optimal, jax_time_optimal, 0.12),
}


def _x0s(config, n):
    """The first ``n`` initial states of the batch of ``chip_smoke.py``:
    config 2 x0 ~ U(−1.5, 1.5)² from seed 1, config 3 x0 = [d, 0] with
    d ~ U(0.5, 2) from seed 2, float32."""
    if config == "vdp_ms":
        x0s = np.random.default_rng(1).uniform(-1.5, 1.5, (BATCH, 2))
    else:
        d = np.random.default_rng(2).uniform(0.5, 2.0, (BATCH,)).astype(np.float32)
        x0s = np.stack([d, np.zeros_like(d)], axis=1)
    return x0s.astype(np.float32)[:n]


def _oracle_cfg():
    return SQPConfig(
        max_iter=50,
        qp=QPConfig(max_iter=4000, iters_per_round=100, rho=1.0, tol=1e-10,
                    backend="plain"),
        tol_stat=1e-8, tol_feas=1e-9,
    )


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    with jax.enable_x64(False):
        for config, (_, jax_builder, dt0) in CONFIGS.items():
            ocp, cfg = jax_builder(N, jnp.float32)
            cfg = cfg.replace(qp=cfg.qp.replace(backend="fused"))

            @jax.jit
            def solve_one(x0, ocp=ocp, cfg=cfg, dt0=dt0):
                o = ocp.replace(bc=ocp.bc.replace(x0=x0))
                xf = o.bc.xf if o.bc.xf is not None else o.refs.xref[-1]
                traj0 = JaxTrajectory.linear_interp(x0, xf, N, 1, dt0)
                r = jax_sqp_solve(o, traj0, cfg)
                return r.traj.U, r.objective, r.status, r.iterations

            lanes = [solve_one(jnp.asarray(x0)) for x0 in _x0s(config, 8)]
            out[config] = [np.stack([np.asarray(o[i]) for o in lanes]) for i in range(4)]
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_nonlinear_slice_matches_jax(jax_results, config):
    U_j, obj_j, status_j, iters_j = jax_results[config]
    assert U_j.dtype == np.float32
    assert iters_j.min() >= 2, "expected real SQP iterations on every lane"
    assert (np.abs(U_j) > 0.999).any(), "no lane has an active bound"

    make, _, dt0 = CONFIGS[config]
    ocp, cfg = make(N=N, device="cpu")
    if config == "vdp_ms":  # config 3 names the fused backend itself
        cfg = cfg.replace(qp=cfg.qp.replace(backend="fused"))
    assert cfg.qp.backend == "fused"
    solver = make_batched_solver(ocp, cfg, dt_init=dt0, device="cpu")
    U, obj, status, iters = solver(_x0s(config, 8))
    assert U.dtype == torch.float32 and U.shape == (8, N, 1)
    np.testing.assert_array_equal(to_np(status), status_j)
    d_it = np.abs(to_np(iters).astype(int) - iters_j.astype(int))
    assert d_it.max() <= 1, (to_np(iters), iters_j)
    assert (d_it == 0).mean() >= 0.8, (to_np(iters), iters_j)
    np.testing.assert_allclose(to_np(U), U_j, rtol=0, atol=2e-4)
    np.testing.assert_allclose(to_np(obj), obj_j, rtol=1e-4, atol=0)
    assert bool((status == 1).all())


@pytest.mark.parametrize("config", list(CONFIGS))
def test_box_qp_kernel_gets_per_lane_operands_once_per_iteration(monkeypatch, config):
    """What the solver hands the box-QP kernel's wrapper: one call per
    lock-step SQP iteration (the iteration count of the slowest lane), Hd, J,
    K with a lane stride (per lane, never a broadcast view the launcher would
    read as one shared copy), nc = 2 / 3, two rounds and no KKT exit."""
    calls = []
    real = admm_kernel.boxqp_solve

    def recording(*args, **kw):
        calls.append(dict(strides=[a.stride(0) for a in args[:3]],
                          nc=args[1].shape[2], Kst=args[0].shape[1], kw=kw))
        return real(*args, **kw)

    monkeypatch.setattr(admm_kernel, "boxqp_solve", recording)
    make, _, dt0 = CONFIGS[config]
    ocp, cfg = make(N=N, device="cpu")
    cfg = cfg.replace(qp=cfg.qp.replace(backend="fused"))
    _, _, status, iters = make_batched_solver(ocp, cfg, dt_init=dt0, device="cpu")(
        _x0s(config, 4))
    assert bool((status == 1).all())
    assert len(calls) == int(iters.max()) > 1
    for c in calls:
        assert all(s > 0 for s in c["strides"]), c
        assert (c["nc"], c["Kst"]) == ((2 if config == "vdp_ms" else 3), N + 1)
        assert c["kw"]["n_rounds"] == 2
        assert c["kw"]["tol_stat"] == 0.0 and c["kw"]["tol_feas"] == 0.0


def test_time_optimal_f64_reaches_the_analytic_optimum():
    """Float64, backend 'plain': Σdt = 2√d to 1e-6 on 3 lanes; the fused
    backend that config 3 names refuses float64."""
    ocp, cfg = entry.time_optimal(N=N, dtype=torch.float64, device="cpu")
    x0s = _x0s("time_optimal", 3).astype(np.float64)
    with pytest.raises(TypeError):
        make_batched_solver(ocp, cfg, dt_init=0.12, device="cpu",
                            dtype=torch.float64)(x0s)
    solver = make_batched_solver(ocp, _oracle_cfg(), dt_init=0.12, device="cpu",
                                 dtype=torch.float64)
    U, T, status, iters = solver(x0s)
    assert T.dtype == torch.float64 and bool((status == 1).all())
    np.testing.assert_allclose(to_np(T), 2.0 * np.sqrt(x0s[:, 0]), rtol=0, atol=1e-6)
    assert float(U.abs().max()) <= 1.0 + 1e-9


def test_golden_file_is_the_chip_runs_inputs():
    gold = np.load(GOLDEN)
    np.testing.assert_array_equal(gold["x0s"], _x0s("vdp_ms", 48))
    assert gold["U"].shape == (48, 20, 1) and gold["U"].dtype == np.float64
    assert gold["converged"].all() and np.isfinite(gold["obj"]).all()
    assert np.abs(gold["U"]).max() <= 1.0 + 1e-8 and np.abs(gold["U"]).max() > 0.999


def test_vdp_ms_f64_matches_oracle_golden():
    gold = np.load(GOLDEN)
    lanes = [0, 1, 2]
    ocp, _ = entry.vdp_ms(N=20, dtype=torch.float64, device="cpu")
    solver = make_batched_solver(ocp, _oracle_cfg(), dt_init=0.1, device="cpu",
                                 dtype=torch.float64)
    U, obj, status, iters = solver(gold["x0s"][lanes].astype(np.float64))
    assert U.dtype == torch.float64 and bool((status == 1).all())
    assert float(np.abs(to_np(U) - gold["U"][lanes]).max()) <= 1e-6
    np.testing.assert_allclose(to_np(obj), gold["obj"][lanes], rtol=1e-8)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_entry_points_run_on_the_card_unless_asked(config):
    """``device=None`` means the card: without one, the entry point and the
    batched solver raise instead of falling back to the CPU."""
    make, _, dt0 = CONFIGS[config]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        make()
    ocp, cfg = make(device="cpu")
    with pytest.raises(RuntimeError):
        make_batched_solver(ocp, cfg, dt_init=dt0)
