"""The closed loop's step graphs (``sim/step_graphs.py``) on the CPU, where
their two parts run as plain calls: the pieces of ``sqp_solve`` composed as
the graphs compose them (one unconditional loop trip after the one-shot)
answer as ``sqp_solve`` does, bit for bit; ``StepGraphs`` answers as
``run_closed_loop`` does, bit for bit, and advances the same SQP counters;
``one_shot_applies`` says what ``sqp_solve`` does; ``graph_engages`` takes
the step graphs for config 5's controller on the card and for nothing
else. Capture and replay themselves run on the card
only (``chip_smoke.py``, phase ``closed_loop_graph``)."""
import pytest
import torch

from control_box_rst_tpu_torch import entry
from control_box_rst_tpu_torch.control import DualModeController, LqrController
from control_box_rst_tpu_torch.ocp.adaptation import SimpleShrinkingHorizon
from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.parallel import make_batched_closed_loop, sharded_solve
from control_box_rst_tpu_torch.sim import GaussianNoise, run_closed_loop
from control_box_rst_tpu_torch.sim.step_graphs import StepGraphs, graph_engages
from control_box_rst_tpu_torch.solvers.sqp import (
    one_shot_applies,
    sqp_begin,
    sqp_finish,
    sqp_rest,
    sqp_solve,
)
from control_box_rst_tpu_torch.utils.profiling import last_record

CUDA = torch.device("cuda")


def _config1(N, dtype, backend, x0, **cfg_changes):
    ocp, cfg = entry.flagship(N, dtype=dtype, device="cpu")
    cfg = cfg.replace(qp=cfg.qp.replace(backend=backend), **cfg_changes)
    traj0 = Trajectory.linear_interp(x0, torch.zeros(2, dtype=dtype), N, 1, 0.1)
    return ocp.replace(bc=ocp.bc.replace(x0=x0)), traj0, cfg


def _x0(n, dtype, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand(n, 2, generator=g, dtype=torch.float64) * 2 - 1) * scale).to(dtype)


def _as_graphed(ocp, traj0, cfg):
    """``sqp_solve`` as the step graphs run it: the set-up and one-shot, one
    loop trip whatever the test says, then trips while a lane needs one."""
    ctx, s, more = sqp_begin(ocp, traj0, cfg)
    s, _ = sqp_rest(ctx, s, more)
    return sqp_finish(ctx, s)


def _assert_same_result(got, want):
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        pairs = [(getattr(a, f), getattr(b, f)) for f in ("X", "U", "dts")] \
            if name == "traj" else [(a, b)]
        for x, y in pairs:
            assert x.dtype == y.dtype and torch.equal(x, y), name


def _converged_in_one_shot(dtype):
    """Lanes of a config-1 batch that the one-shot solves alone."""
    ocp, traj0, cfg = _config1(50, dtype, "fused", _x0(64, dtype))
    first = sqp_solve(ocp, traj0, cfg)
    return _x0(64, dtype)[first.iterations == 1]


@pytest.mark.parametrize("case", ["one_shot_only", "several_trips", "float64_plain"])
def test_the_pieces_with_an_unconditional_trip_are_sqp_solve(case):
    """Config 1: where every lane converges in the one-shot (the extra trip
    is over frozen lanes), where lanes need two or three loop trips after it
    (a tighter stationarity tolerance), and in float64 without the
    one-shot (the plain QP)."""
    if case == "one_shot_only":
        x0 = _converged_in_one_shot(torch.float32)
        ocp, traj0, cfg = _config1(50, torch.float32, "fused", x0)
    elif case == "several_trips":
        ocp, traj0, cfg = _config1(50, torch.float32, "fused", _x0(64, torch.float32),
                                   tol_stat=1e-5)
    else:
        ocp, traj0, cfg = _config1(20, torch.float64, "plain", _x0(16, torch.float64))
    want = sqp_solve(ocp, traj0, cfg)
    iters = want.iterations
    if case == "one_shot_only":
        assert x0.shape[0] >= 32 and int(iters.max()) == 1
    elif case == "several_trips":
        assert int(iters.min()) == 1 and int(iters.max()) >= 3
    else:
        assert int(iters.min()) >= 2
    _assert_same_result(_as_graphed(ocp, traj0, cfg), want)


def test_van_der_pol_from_the_pieces_is_sqp_solve():
    """Config 2 (per-lane J, K and Hd, the line search at work) composed
    from the same pieces."""
    ocp, cfg = entry.vdp_ms(8, dtype=torch.float64, device="cpu")
    cfg = cfg.replace(qp=cfg.qp.replace(backend="plain"))
    x0 = _x0(6, torch.float64, scale=1.5, seed=3)
    ocp = ocp.replace(bc=ocp.bc.replace(x0=x0))
    traj0 = Trajectory.linear_interp(x0, torch.zeros(2, dtype=torch.float64), 8, 1, 0.1)
    want = sqp_solve(ocp, traj0, cfg)
    assert int(want.iterations.max()) >= 3
    _assert_same_result(_as_graphed(ocp, traj0, cfg), want)


def _controller(dtype, backend, **cfg_changes):
    """Config 5's controller at N = 20 on the CPU, its plant and interval."""
    ctrl, plant, _, dt = entry.rollouts(20, dtype=dtype, device="cpu")
    cfg = ctrl.cfg.replace(qp=ctrl.cfg.qp.replace(backend=backend), **cfg_changes)
    return ctrl.replace(cfg=cfg), plant, dt


def _assert_same_loop(got, want):
    for name in ("ts", "x_true", "y", "x_observed", "u", "ok"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert list(got.info) == list(want.info)
    for k, v in want.info.items():
        assert got.info[k].dtype == v.dtype and torch.equal(got.info[k], v), k


@pytest.mark.parametrize("dtype, backend", [(torch.float32, "fused"), (torch.float64, "plain")])
def test_step_graphs_are_the_eager_closed_loop(dtype, backend):
    """Rollouts of config 5 (N = 20, 6 steps) through ``StepGraphs`` equal
    ``run_closed_loop``'s in every field, in float32 with the fused QP and in
    float64 with the plain one; one object runs two batches in a row."""
    ctrl, plant, dt = _controller(dtype, backend)
    graphs = StepGraphs(ctrl, plant, 12, dt)
    for seed in (1, 2):
        x0 = _x0(12, dtype, seed=seed)
        _assert_same_loop(graphs.run(x0, 6), run_closed_loop(plant, ctrl, x0, 6, dt))


def test_make_batched_closed_loop_through_the_step_graphs(monkeypatch):
    """With the engage test answering yes (on the CPU it says no),
    ``make_batched_closed_loop`` keeps one ``StepGraphs``, built again when
    the batch size changes, and answers as its eager loop."""
    ctrl, plant, dt = _controller(torch.float32, "fused")
    x0 = _x0(8, torch.float32, seed=4).numpy()
    eager = make_batched_closed_loop(ctrl, plant, 4, dt, device="cpu")
    want, want_4 = eager(x0), eager(x0[:4])
    engaged, built = [], []

    class Counted(StepGraphs):
        def __init__(self, *args):
            built.append(args[2])
            super().__init__(*args)

    monkeypatch.setattr(sharded_solve, "graph_engages", lambda *a: engaged.append(a) or True)
    monkeypatch.setattr(sharded_solve, "StepGraphs", Counted)
    roll = make_batched_closed_loop(ctrl, plant, 4, dt, device="cpu")
    _assert_same_loop(roll(x0), want)
    _assert_same_loop(roll(x0), want)
    _assert_same_loop(roll(x0[:4]), want_4)
    assert len(engaged) == 1 and built == [8, 4]


def test_the_step_graphs_advance_the_eager_loops_counters():
    """The step graphs count the eager loop's lock-step SQP iterations,
    useful lane iterations and lane slots, and one more loop trip (over
    frozen lanes) at each step where the eager loop ran none after the
    one-shot; plus one graph step a step and the trips they ran after the
    first graph. The eager loop counts its steps. A tighter stationarity
    tolerance gives steps of one, two and three trips."""
    ctrl, plant, dt = _controller(torch.float32, "fused", tol_stat=1e-5)
    x0 = _x0(16, torch.float32, seed=5)
    graphs = StepGraphs(ctrl, plant, 16, dt)
    counters = {}
    for name, run in (("eager", lambda: run_closed_loop(plant, ctrl, x0, 5, dt)),
                      ("graphs", lambda: graphs.run(x0, 5))):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            res = run()
        counters[name] = last_record().counters()
    lock = res.info["sqp_iters"].amax(dim=0)  # [T] lock-step iterations of each step
    assert int(lock.min()) == 1 and int(lock.max()) >= 3
    no_trip = int((lock == 1).sum())
    eager, graph = counters["eager"], counters["graphs"]
    assert eager["sqp.lockstep_iters"] == int(lock.sum())
    assert graph["sqp.lockstep_iters"] == eager["sqp.lockstep_iters"] + no_trip
    assert graph["sqp.lane_slots"] == eager["sqp.lane_slots"] + 16 * no_trip
    assert graph["sqp.lane_iters"] == eager["sqp.lane_iters"] == int(res.info["sqp_iters"].sum())
    assert eager["closed_loop.eager_steps"] == graph["closed_loop.graph_steps"] == 5
    trips = int(torch.clamp(lock - 2, min=0).sum())
    assert graph["closed_loop.eager_trips"] == trips
    assert "closed_loop.graph_steps" not in eager and "closed_loop.eager_steps" not in graph


@pytest.fixture(scope="module")
def config5():
    ctrl, plant, _, _ = entry.rollouts(50, device="cpu")
    return ctrl, plant


def test_the_engage_test_takes_config_5_on_the_card(config5):
    ctrl, plant = config5
    assert graph_engages(ctrl, plant, None, CUDA)
    assert graph_engages(ctrl, plant, None, "cuda:0")


@pytest.fixture(scope="module")
def refusals(config5):
    ctrl, plant = config5
    ip_ctrl, _, _, _ = entry.rollouts_ip(8, device="cpu")
    lm_ocp, lm_cfg = entry.flagship_lm(8, device="cpu")
    dm_ctrl, dm_plant, _, _, observer = entry.kalman_dual_mode(10, device="cpu")
    noisy = GaussianNoise(std=0.01)
    lqr = LqrController(K=torch.zeros(1, 2))
    return {
        "cpu": (ctrl, plant, None, "cpu"),
        "lm": (ctrl.replace(solver="lm", lm_cfg=lm_cfg), plant, None, CUDA),
        "ip": (ip_ctrl, plant, None, CUDA),
        "dual_mode": (DualModeController(global_controller=ctrl, local_controller=lqr,
                                         S=torch.eye(2), xf=torch.zeros(2)),
                      plant, None, CUDA),
        "kalman_dual_mode": (dm_ctrl, dm_plant, observer, CUDA),
        "adaptation": (ctrl.replace(adaptation=SimpleShrinkingHorizon()), plant, None, CUDA),
        "plain_qp": (ctrl.replace(cfg=ctrl.cfg.replace(qp=ctrl.cfg.qp.replace(backend="plain"))),
                     plant, None, CUDA),
        "float64": (ctrl.to("cpu", torch.float64), plant, None, CUDA),
        "two_solves_a_step": (ctrl.replace(num_ocp_iterations=2), plant, None, CUDA),
        "state_noise": (ctrl, plant.replace(state_noise=noisy), None, CUDA),
        "output_noise": (ctrl, plant.replace(output_noise=noisy), None, CUDA),
        "input_noise": (ctrl, plant.replace(input_noise=noisy), None, CUDA),
        "observer": (ctrl, plant, observer, CUDA),
    }


REFUSED = ["cpu", "lm", "ip", "dual_mode", "kalman_dual_mode", "adaptation", "plain_qp",
           "float64", "two_solves_a_step", "state_noise", "output_noise", "input_noise",
           "observer"]


@pytest.mark.parametrize("case", REFUSED)
def test_the_engage_test_refuses_every_other_loop(case, refusals):
    assert not graph_engages(*refusals[case])


BUILDERS = {"config1": entry.flagship, "move_blocking": entry.move_blocking,
            "van_der_pol": entry.vdp_ms, "time_optimal": entry.time_optimal,
            "general_rows": entry.constrained_di}


@pytest.mark.parametrize("case, one_shot", [
    ("config1_fused", True), ("config1_plain", False), ("move_blocking_fused", True),
    ("van_der_pol_fused", False), ("time_optimal_fused", False),
    ("general_rows_fused", False)])
def test_one_shot_applies_says_what_the_solve_does(case, one_shot):
    """The predicate the engage test shares with ``sqp_solve``: the LTI
    problems with a constant Hessian (config 1, move blocking) take the
    one-shot with the fused QP, not with the plain one; Van der Pol (J, K
    and Hd move with the iterate), the time-optimal grid (dt a variable)
    and general rows never take it. Where the solve runs, its context
    agrees."""
    name, backend = case.rsplit("_", 1)
    N = 10
    ocp, cfg = BUILDERS[name](N, dtype=torch.float32, device="cpu")[:2]
    cfg = cfg.replace(qp=cfg.qp.replace(backend=backend))
    assert one_shot_applies(ocp, cfg) is one_shot
    if ocp.ng == 0:
        x0 = _x0(4, torch.float32, seed=6)
        ocp = ocp.replace(bc=ocp.bc.replace(x0=x0))
        traj0 = Trajectory.linear_interp(x0, torch.zeros(2), N, ocp.nu, 0.1)
        assert sqp_begin(ocp, traj0, cfg)[0].one_shot is one_shot
