"""PyTorch port vs JAX package: the closed loop's parts (config 5).

The shift functions of ``control/predictive.py`` against the JAX functions on
random W with a shift count per lane (exact, float64); the asserts of
``tests/test_adaptation.py`` on their semantics; one controller step against
the JAX step from the same mid-rollout carry (handed to both through
``convert.mpc_carry_from_numpy``; float64, plain backend, 1e-8); the hoisted
LTI structure against the per-lane one (1e-12); ``make_batched_closed_loop``
on the CPU (a lane of the batch is a single run; what a float32 fused rollout
hands the box-QP kernel's launcher: one call per MPC step for the one-shot
solve and one per lock-step outer SQP iteration, Hd/J/K as one shared copy);
``run_open_loop`` against the JAX function; the noise of the simulated plant
(same seed, same bits; mean and std in distribution); what is not ported yet
raises by name.

The JAX side runs under ``jax.jit`` (eager ``jax.grad`` was seen to corrupt
the heap on this backend).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.control import PredictiveController as JaxController
from control_box_rst_tpu.control.predictive import (
    find_nearest_state as jax_find_nearest_state,
    shift_stage_rows as jax_shift_stage_rows,
    shift_warm_start as jax_shift_warm_start,
)
from control_box_rst_tpu.solvers import QPConfig as JaxQPConfig
from control_box_rst_tpu.solvers import SQPConfig as JaxSQPConfig
from control_box_rst_tpu_torch import convert, entry
from control_box_rst_tpu_torch.control import (
    PredictiveController,
    find_nearest_state,
    shift_stage_rows,
    shift_warm_start,
)
from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
from control_box_rst_tpu_torch.ops.cuda import admm_kernel
from control_box_rst_tpu_torch.parallel import make_batched_closed_loop
from control_box_rst_tpu_torch.sim import (
    GaussianNoise,
    SimulatedPlant,
    SteadyStateKalmanObserver,
    benchmark_varying_initial_state,
    run_closed_loop,
)
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

from torch_port_util import jax_flagship, jax_vdp_ms, to_np, torch_ocp_like

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _random_W(seed, B, N, nx=2, nz=4):
    """Random walks along a drifting path (so distances grow along the
    plan), random controls, dt column 0.1 with stage N's dummy 0."""
    rng = np.random.default_rng(seed)
    steps = 0.3 + 0.05 * rng.standard_normal((B, N + 1, nx))
    X = np.cumsum(steps, axis=1)
    rest = rng.standard_normal((B, N + 1, nz - nx))
    rest[:, :, -1] = 0.1
    rest[:, -1, :] = 0.0
    return np.concatenate([X, rest], axis=2)


def test_find_nearest_state_matches_jax():
    """Per-lane counts 0 (unchanged start), 1, 2, a few, past the lookahead
    (capped at min(20, N−1)), beyond the end of the plan; without and with a
    per-lane n_active (N and shorter). Exact."""
    N, nx = 30, 2
    W = _random_W(0, 7, N)
    rng = np.random.default_rng(1)
    targets = [0, 1, 2, 5, 25, 30, 12]
    x0 = np.stack([W[b, k, :nx] for b, k in enumerate(targets)])
    x0[1:] += 1e-3 * rng.standard_normal((6, nx))
    n_active = np.array([N, N, N, N, N, N, 8], np.int32)
    jfind = jax.jit(jax.vmap(jax_find_nearest_state, in_axes=(0, 0, None)), static_argnums=2)
    jfind_m = jax.jit(jax.vmap(lambda w, x, n: jax_find_nearest_state(w, x, nx, n_active=n)))
    for n in (None, n_active):
        k = find_nearest_state(torch.as_tensor(W), torch.as_tensor(x0), nx,
                               n_active=None if n is None else torch.as_tensor(n))
        want = jfind(W, x0, nx) if n is None else jfind_m(W, x0, n)
        assert k.dtype == torch.int32
        np.testing.assert_array_equal(to_np(k), np.asarray(want))
    assert to_np(k).tolist()[:6] == [0, 1, 2, 5, 20, 20]


def test_shift_warm_start_and_stage_rows_match_jax():
    """Per-lane counts 0, 1, 2, N−1 and past the end (tail extrapolation),
    with and without a per-lane n_active (the u/dt clamp). Exact against the
    JAX functions run op by op: under ``jax.jit`` XLA contracts the tail
    extrapolation x_N + over·(x_N − x_{N−1}) into a fused multiply-add,
    which moves that entry by an ulp."""
    N, nx = 12, 2
    W = _random_W(2, 6, N)
    ks = np.array([0, 1, 2, N - 1, N + 3, 4], np.int32)
    n_active = np.array([N, N, 5, N, N, 3], np.int32)
    jshift = jax.vmap(lambda w, k: jax_shift_warm_start(w, nx, k))
    jshift_m = jax.vmap(lambda w, k, n: jax_shift_warm_start(w, nx, k, n_active=n))
    got = shift_warm_start(torch.as_tensor(W), nx, torch.as_tensor(ks))
    np.testing.assert_array_equal(to_np(got), np.asarray(jshift(W, ks)))
    got = shift_warm_start(torch.as_tensor(W), nx, torch.as_tensor(ks),
                           n_active=torch.as_tensor(n_active))
    np.testing.assert_array_equal(to_np(got), np.asarray(jshift_m(W, ks, n_active)))
    # one count for every lane
    np.testing.assert_array_equal(
        to_np(shift_warm_start(torch.as_tensor(W), nx, 2)),
        np.asarray(jax.vmap(lambda w: jax_shift_warm_start(w, nx, 2))(W)))
    rng = np.random.default_rng(3)
    for rows, last in (((N, 2), N - 1), ((N + 1, 4), N), ((N + 1, 0), N)):
        y = rng.standard_normal((6,) + rows)
        want = jax.jit(jax.vmap(lambda a, k: jax_shift_stage_rows(a, k, last)))(y, ks)
        got = shift_stage_rows(torch.as_tensor(y), torch.as_tensor(ks), last)
        np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_find_nearest_state_semantics():
    """The asserts of the JAX package's own test: 0 for an unchanged start,
    the nearest index while distances decrease, capped at N−1, and a masked
    horizon keeps the walk out of the inactive tail."""
    X = torch.tensor([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [3.0, 0.0], [4.0, 0.0]],
                     dtype=torch.float64)
    W = torch.cat([X, torch.zeros(5, 2, dtype=torch.float64)], dim=1)
    x = lambda *v: torch.tensor(v, dtype=torch.float64)
    assert int(find_nearest_state(W, x(0.0, 0.0), 2)) == 0
    assert int(find_nearest_state(W, x(2.1, 0.0), 2)) == 2
    assert int(find_nearest_state(W, x(9.0, 0.0), 2)) == 3
    assert int(find_nearest_state(W, x(9.0, 0.0), 2, n_active=torch.tensor(2))) == 1


def test_shift_warm_start_dynamic_count():
    """The asserts of the JAX package's own test: k=0 is the identity; k=1
    drops the first stage, extrapolates the tail state linearly, holds the
    last control and keeps stage N's dummies 0; k=2 extrapolates two stages
    along the last planned interval."""
    N, nx, nu = 4, 2, 1
    X = torch.arange(N + 1, dtype=torch.float64)[:, None] * torch.tensor([[1.0, 10.0]],
                                                                         dtype=torch.float64)
    U = 0.1 * torch.arange(N, dtype=torch.float64)[:, None]
    U_pad = torch.cat([U, torch.zeros(1, nu, dtype=torch.float64)])
    dts = torch.cat([torch.full((N,), 0.1, dtype=torch.float64),
                     torch.zeros(1, dtype=torch.float64)])[:, None]
    W = torch.cat([X, U_pad, dts], dim=1)
    torch.testing.assert_close(shift_warm_start(W, nx, 0), W, rtol=0, atol=1e-15)
    W1 = shift_warm_start(W, nx, 1)
    torch.testing.assert_close(W1[:-1, :nx], X[1:], rtol=0, atol=1e-15)
    torch.testing.assert_close(W1[-1, :nx], 2 * X[-1] - X[-2], rtol=0, atol=1e-15)
    torch.testing.assert_close(W1[:-2, nx], U[1:, 0], rtol=0, atol=1e-15)
    assert float(W1[-2, nx]) == float(U[-1, 0])
    assert float(W1[-1, nx]) == 0.0
    W2 = shift_warm_start(W, nx, 2)
    torch.testing.assert_close(W2[-1, :nx], X[-1] + 2 * (X[-1] - X[-2]), rtol=0, atol=1e-15)


# --------------------------------------------------------------------------
# one controller step from a mid-rollout carry
# --------------------------------------------------------------------------

STEP_CONFIGS = {
    # name: (JAX OCP factory, N, SQP settings of the float64 comparison)
    "flagship": (jax_flagship, 10, dict(max_iter=10, qp=dict(max_iter=200, tol=1e-10))),
    "vdp_ms": (jax_vdp_ms, 8, dict(max_iter=20, qp=dict(max_iter=200, tol=1e-10))),
}


def _controllers(config):
    make, N, settings = STEP_CONFIGS[config]
    jocp, _ = make(N, jnp.float64)
    jcfg = JaxSQPConfig(max_iter=settings["max_iter"], qp=JaxQPConfig(**settings["qp"]))
    jctrl = JaxController(nx=2, nu=1, ocp=jocp, dt=0.1, cfg=jcfg)
    cfg = SQPConfig(max_iter=settings["max_iter"], qp=QPConfig(**settings["qp"]))
    ctrl = PredictiveController(nx=2, nu=1, ocp=torch_ocp_like(jocp, "float64"), dt=0.1,
                                cfg=cfg, **CPU64)
    return jctrl, ctrl


def _mid_rollout(jctrl, x0s):
    """The JAX carry after one step from x0s, and measured states that make
    the next shift count 0, 1 and 2 on different lanes."""
    init = jax.jit(jax.vmap(jctrl.init_carry))
    step = jax.jit(jax.vmap(lambda c, x: jctrl.step(c, x, 0.0, 0.1)))
    carry, out = step(init(x0s), x0s)
    X = np.asarray(out.x_seq)
    x1 = np.stack([X[0, 0], X[1, 1] + 1e-3, X[2, 2] - 1e-3])
    return carry, x1, step


@pytest.mark.parametrize("config", list(STEP_CONFIGS))
def test_controller_step_matches_jax(config):
    """From the same mid-rollout carry (shifted by 0, 1 and 2 stages on
    different lanes, nonzero duals) the port's step and the JAX step give the
    same carry and the same output, float64, to 1e-8."""
    jctrl, ctrl = _controllers(config)
    x0s = np.array([[0.8, -0.3], [-0.5, 0.4], [0.2, 0.9]])
    carry, x1, step = _mid_rollout(jctrl, x0s)
    assert float(np.abs(np.asarray(carry.y_dyn)).max()) > 0
    jc, jout = step(carry, x1)
    tc, tout = ctrl.step(
        convert.mpc_carry_from_numpy({k: np.asarray(v) for k, v in carry._asdict().items()},
                                     **CPU64),
        torch.as_tensor(x1), 0.0, 0.1)
    for name in jc._fields:
        np.testing.assert_allclose(to_np(getattr(tc, name)), np.asarray(getattr(jc, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
    for name in ("u", "u_seq", "x_seq", "ok"):
        np.testing.assert_allclose(to_np(getattr(tout, name)), np.asarray(getattr(jout, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
    assert set(tout.info) == set(jout.info)
    for name, v in jout.info.items():
        np.testing.assert_allclose(to_np(tout.info[name]), np.asarray(v), rtol=0, atol=1e-8,
                                   err_msg=name)


def test_hoisted_structure_gives_the_per_lane_step():
    """Config 1 is LTI with a constant Hessian: the controller evaluates J,
    K, Hd once, unbatched, at construction. A step with them and a step that
    evaluates them per lane from the carry agree to 1e-12; a nonlinear OCP
    gets no hoisted structure."""
    jctrl, ctrl = _controllers("flagship")
    assert ctrl.hoisted.Jm.dim() == 3 and ctrl.hoisted.Hm.dim() == 3
    x0s = torch.tensor([[0.8, -0.3], [-0.5, 0.4], [0.2, 0.9]], dtype=torch.float64)
    carry, out = ctrl.step(ctrl.init_carry(x0s), x0s, 0.0, 0.1)
    x1 = out.x_seq[:, 1] + 1e-3
    per_lane = ctrl.replace()
    object.__setattr__(per_lane, "hoisted", None)
    c_h, o_h = ctrl.step(carry, x1, 0.1, 0.1)
    c_l, o_l = per_lane.step(carry, x1, 0.1, 0.1)
    for a, b in zip(c_h, c_l):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    torch.testing.assert_close(o_h.u_seq, o_l.u_seq, rtol=0, atol=1e-12)
    _, nonlinear = _controllers("vdp_ms")
    assert nonlinear.hoisted == (None, None, None)


# --------------------------------------------------------------------------
# batched rollouts on the CPU
# --------------------------------------------------------------------------

def _flagship_controller(N, dtype, backend=None):
    ocp, cfg = entry.flagship(N, dtype=dtype, device="cpu")
    cfg = cfg.replace(qp=cfg.qp.replace(backend=backend))
    return PredictiveController(nx=2, nu=1, ocp=ocp, dt=0.1, cfg=cfg, device="cpu", dtype=dtype)


def test_a_lane_of_the_batch_is_a_single_run():
    ctrl = _flagship_controller(10, torch.float64)
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    x0s = torch.tensor([[0.9, -0.2], [-0.4, 0.6], [0.3, 0.1]], dtype=torch.float64)
    roll = make_batched_closed_loop(ctrl, plant, 6, 0.1, **CPU64)
    batch = roll(x0s.numpy())
    single = run_closed_loop(plant, ctrl, x0s[1], 6, 0.1)
    assert batch.u.shape == (3, 6, 1) and batch.x_true.shape == (3, 7, 2)
    assert single.u.shape == (6, 1) and single.ts.shape == (6,)
    for a, b in zip(batch[:-1], single[:-1]):
        torch.testing.assert_close(a[1], b, rtol=0, atol=1e-12)
    for k, v in single.info.items():
        torch.testing.assert_close(batch.info[k][1], v, rtol=0, atol=1e-12)
    assert bool(batch.ok.all())


class _RecordingLib:
    """Stands in for the loaded box-QP library: records what the wrapper's
    launcher hands to the shared-memory kernel and launches nothing."""

    def __init__(self):
        self.calls = []

    def admm_smem_floats_per_lane(self, Kst, shared):
        return admm_kernel.state_bytes_per_lane(Kst, 4, 2, bool(shared)) // 4

    def boxqp_solve_smem_launch(self, p, B, Kst, shared, *rest):
        self.calls.append(dict(B=B, Kst=Kst, shared=shared, tol_stat=rest[8]))
        return 0


def test_fused_rollout_launches_the_box_qp_kernel_once_per_step_and_outer_iteration(monkeypatch):
    """A float32 rollout with the fused backend hands the box-QP kernel's
    launcher one call per MPC step (the warm-started one-shot solve, KKT exit
    on) plus one per lock-step outer SQP iteration (KKT exit off), every one
    with Hd/J/K as one shared copy (hoisted once); on the CPU the plain
    version answers each call."""
    lib = _RecordingLib()
    real = admm_kernel.boxqp_solve

    def recording(*args, **kw):
        names = ("n_rounds", "iters", "tol", "sigma", "alpha", "rho_eq_scale", "rho_min",
                 "rho_max", "tol_stat", "tol_feas")
        dims = admm_kernel._check_args(args)
        admm_kernel._launch_smem(lib, "boxqp_solve", args, dims,
                                 tuple(kw[n] for n in names), 0)
        return real(*args, **kw)

    monkeypatch.setattr(admm_kernel, "boxqp_solve", recording)
    admm_kernel.reset_launch_counts()
    T, B = 4, 32
    ctrl = _flagship_controller(50, torch.float32, backend="fused")
    assert ctrl.sqp_cfg.qp.backend == "fused"
    roll = make_batched_closed_loop(ctrl, SimulatedPlant(system=DoubleIntegratorContinuous()),
                                    T, 0.1, device="cpu")
    # the first lanes of the card's rollout batch
    x0s = np.random.default_rng(0).uniform(-1, 1, (B, 2)).astype(np.float32)
    res = roll(x0s)
    lock_step = res.info["sqp_iters"].amax(dim=0)
    assert len(lib.calls) == admm_kernel.LAUNCHES["boxqp_solve"] == int(lock_step.sum())
    assert sum(c["tol_stat"] > 0 for c in lib.calls) == T
    assert int(lock_step.max()) > 1  # outer SQP iterations happen, too
    assert all(c["shared"] == 1 and c["B"] == B and c["Kst"] == 51 for c in lib.calls)
    info = admm_kernel.LAUNCH_INFO["boxqp_solve"]
    assert info["shared_hjk"] and info["route"] == "smem"
    assert bool(res.ok.all()) and bool(torch.isfinite(res.u).all())


def test_rollout_entry_is_config_5():
    """``entry.rollouts``: the config-1 OCP under the controller, the plant
    integrating with RK4 in 4 substeps and no noise, 20 steps of 0.1; on the
    CPU float32 resolves to the plain backend, Hd/J/K hoisted once."""
    ctrl, plant, T, dt = entry.rollouts(N=8, device="cpu")
    ocp, cfg = entry.flagship(N=8, device="cpu")
    assert (T, dt, ctrl.ocp.N, ctrl.dt) == (20, 0.1, 8, 0.1)
    assert vars(ctrl.cfg.qp) == vars(cfg.qp) and ctrl.sqp_cfg.qp.backend == "plain"
    assert ctrl.dtype == torch.float32 and ctrl.ocp.bc.x0.device.type == "cpu"
    assert plant.integrator.name == "rk4" and plant.integrator.num_substeps == 4
    assert plant.state_noise is None and plant.input_noise is None and plant.output_noise is None
    assert ctrl.hoisted.Jm.shape == (8, 2, 4)


def test_benchmark_sweep_is_one_batch_of_rollouts():
    """The x01 × x02 sweep: x01-major lanes, the other states from the
    template, each lane the rollout of its own initial state."""
    ctrl = _flagship_controller(8, torch.float64)
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    res, x0s = benchmark_varying_initial_state(
        plant, ctrl, [0.5, -0.5], [0.1, 0.2, 0.3], 3, 0.1, **CPU64)
    want = torch.tensor([[0.5, 0.1], [0.5, 0.2], [0.5, 0.3], [-0.5, 0.1], [-0.5, 0.2],
                         [-0.5, 0.3]], dtype=torch.float64)
    torch.testing.assert_close(x0s, want, rtol=0, atol=0)
    assert res.u.shape == (6, 3, 1)
    single = run_closed_loop(plant, ctrl, want[4], 3, 0.1)
    torch.testing.assert_close(res.u[4], single.u, rtol=0, atol=1e-12)


def test_run_open_loop_matches_jax():
    """One solve, then the plant rolled along the planned controls on the
    plan's own dts: against the JAX ``run_open_loop`` per initial state,
    float64, 1e-8; an unbatched x0 gives unbatched results."""
    from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
    from control_box_rst_tpu.sim import SimulatedPlant as JaxPlant
    from control_box_rst_tpu.sim import run_open_loop as jax_run_open_loop
    from control_box_rst_tpu_torch.sim import run_open_loop

    jctrl, ctrl = _controllers("flagship")
    jplant = JaxPlant(system=JaxDI())
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    x0s = np.array([[0.8, -0.3], [-0.5, 0.4]])
    run = jax.jit(lambda x: jax_run_open_loop(jplant, jctrl, x, 0.1))
    out, xs = run_open_loop(plant, ctrl, torch.as_tensor(x0s), 0.1)
    assert xs.shape == (2, 11, 2) and out.u_seq.shape == (2, 10, 1)
    for i, x0 in enumerate(x0s):
        jout, jxs = run(x0)
        np.testing.assert_allclose(to_np(xs[i]), np.asarray(jxs), rtol=0, atol=1e-8)
        np.testing.assert_allclose(to_np(out.u_seq[i]), np.asarray(jout.u_seq), rtol=0,
                                   atol=1e-8)
    out1, xs1 = run_open_loop(plant, ctrl, torch.as_tensor(x0s[1]), 0.1)
    assert xs1.shape == (11, 2) and out1.u.shape == (1,)
    torch.testing.assert_close(xs1, xs[1], rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# noise, refusals
# --------------------------------------------------------------------------

def _noisy_plant():
    return SimulatedPlant(
        system=DoubleIntegratorContinuous(),
        state_noise=GaussianNoise(mean=0.05, std=0.2),
        input_noise=GaussianNoise(mean=-0.1, std=0.3),
        output_noise=GaussianNoise(mean=0.0, std=0.01),
    )


def test_noise_is_reproducible_from_the_generator_seed():
    plant = _noisy_plant()
    x = torch.zeros(64, 2, dtype=torch.float64)
    u = torch.zeros(64, 1, dtype=torch.float64)
    draws = []
    for seed in (7, 7, 8):
        g = torch.Generator().manual_seed(seed)
        draws.append(torch.cat([plant.step(x, u, 0.1, g), plant.output(x, g)], dim=1))
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    with pytest.raises(ValueError, match="Generator"):
        plant.step(x, u, 0.1)


def test_noise_mean_and_std_in_distribution():
    """State noise alone (u = 0 from rest keeps the state at 0): the draws
    have the requested mean and std, within 5 standard errors; the JAX
    plant's draws too. Input noise reaches the state through the dynamics:
    its mean effect is that of its mean."""
    n = 20000
    plant = SimulatedPlant(system=DoubleIntegratorContinuous(),
                           state_noise=GaussianNoise(mean=0.05, std=0.2))
    g = torch.Generator().manual_seed(0)
    x = plant.step(torch.zeros(n, 2, dtype=torch.float64), torch.zeros(n, 1, dtype=torch.float64),
                   0.1, g)
    from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
    from control_box_rst_tpu.sim import GaussianNoise as JaxNoise
    from control_box_rst_tpu.sim import SimulatedPlant as JaxPlant

    jplant = JaxPlant(system=JaxDI(), state_noise=JaxNoise(mean=0.05, std=0.2))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    xj = jax.jit(jax.vmap(lambda k: jplant.step(jnp.zeros(2), jnp.zeros(1), 0.1, k)))(keys)
    for sample in (to_np(x), np.asarray(xj)):
        assert np.all(np.abs(sample.mean(axis=0) - 0.05) < 5 * 0.2 / np.sqrt(n))
        assert np.all(np.abs(sample.std(axis=0) - 0.2) < 5 * 0.2 / np.sqrt(2 * n))
    plant_u = SimulatedPlant(system=DoubleIntegratorContinuous(),
                             input_noise=GaussianNoise(mean=-0.1, std=0.3))
    xu = plant_u.step(torch.zeros(n, 2, dtype=torch.float64),
                      torch.zeros(n, 1, dtype=torch.float64), 0.1, g)
    # one interval of constant input w: velocity w·dt
    v = to_np(xu[:, 1]) / 0.1
    assert abs(v.mean() + 0.1) < 5 * 0.3 / np.sqrt(n)
    assert abs(v.std() - 0.3) < 5 * 0.3 / np.sqrt(2 * n)


def test_what_is_not_ported_raises_by_name():
    """Nothing is left unported here: the mesh refuses the CPU unless asked
    (``make_mesh()`` without a card raises, ``device_type="cpu"`` builds the
    one-rank mesh); ``solver='ip'`` (the constrained slice) and the Kalman
    observer (the LQR family) are ported: the one builds its default
    settings, the other its gain."""
    from control_box_rst_tpu_torch.solvers import IPConfig

    ocp, cfg = entry.flagship(N=4, device="cpu")
    kw = dict(nx=2, nu=1, ocp=ocp, dt=0.1, cfg=cfg, device="cpu")
    assert isinstance(PredictiveController(solver="ip", **kw).ip_cfg, IPConfig)
    with pytest.raises(KeyError):
        PredictiveController(solver="newton", **kw)
    obs = SteadyStateKalmanObserver.from_linear(
        torch.eye(2, dtype=torch.float64), torch.zeros((2, 1), dtype=torch.float64),
        torch.eye(2, dtype=torch.float64))
    assert obs.L.shape == (2, 2)
    import torch.distributed as dist

    from control_box_rst_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    try:
        mesh = make_mesh(device_type="cpu")
        assert mesh.size() == 1 and mesh.device_type == "cpu"
        ctrl = PredictiveController(**kw)
        plant = SimulatedPlant(system=DoubleIntegratorContinuous())
        res = make_batched_closed_loop(ctrl, plant, 1, 0.1, mesh=mesh)(np.zeros((2, 2)))
        assert tuple(res.u.shape) == (2, 1, 1) and res.u.to_local().shape[0] == 2
    finally:
        dist.destroy_process_group()


def test_closed_loop_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is allowed to run")
    ocp, cfg = entry.flagship(N=4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictiveController(nx=2, nu=1, ocp=ocp, cfg=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.rollouts(N=4)
    ctrl = PredictiveController(nx=2, nu=1, ocp=ocp, cfg=cfg, device="cpu")
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batched_closed_loop(ctrl, plant, 2, 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark_varying_initial_state(plant, ctrl, [0.1], [0.2], 2, 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.mpc_carry_from_numpy(
            dict(W=np.zeros((1, 5, 4)), y_dyn=np.zeros((1, 4, 2)), y_gen=np.zeros((1, 5, 0)),
                 y_box=np.zeros((1, 5, 4)), u_prev=np.zeros((1, 1)), n_active=np.array([4]),
                 feas_prev=np.zeros(1)))
