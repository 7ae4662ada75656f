"""Entry points of the port.

Counterpart of the JAX package's ``__graft_entry__.py``:

flagship(N)  → (ocp, cfg): the config-1 OCP — H=N double integrator,
               quadratic cost, |u| ≤ 1, Crank–Nicolson finite differences,
               dt pinned at 0.1 — with its solver settings.
flagship_lm(N) → (ocp, LMConfig): the same OCP with the settings of the
               Levenberg-Marquardt backend.
flagship_ip(N) → (ocp, IPConfig): the same OCP with the float32 settings of
               the interior-point backend.
constrained_di(N) → (ocp, SQPConfig, LMConfig, IPConfig): the double
               integrator with the stage row x₂ ≥ −0.9 and the terminal
               equality x_N = 0 (general rows, ng = 2), |u| ≤ 1, dt 0.25.
vdp_ms(N)    → (ocp, cfg): config 2 — Van der Pol, multiple shooting (RK4),
               |u| ≤ 1, dt pinned at 0.1; the nonlinear production
               configuration (the SQP outer loop runs real iterations).
time_optimal(N) → (ocp, cfg): config 3 — rest-to-rest double integrator,
               minimum time, one dt decision variable tied across the
               intervals; analytic optimum T* = 2√d from x0 = [d, 0].
nonuniform_ms_timeopt(N) → (ocp, cfg): config 4 — rest-to-rest double
               integrator, minimum time, non-uniform multiple shooting (RK4)
               with a free dt per interval; optimum T* = 2√d from x0 = [d, 0].
nonuniform_ms_timeopt_adaptive(N) → (controller, plant, T_steps, dt): config
               4 under MPC with the RedundantControls grid adaptation, each
               lane its own active horizon (the reference's golden case 9).
rollouts(N)  → (controller, plant, T_steps, dt): config 5 — the config-1
               OCP under a PredictiveController against the simulated
               double integrator (RK4, 4 substeps, no noise), 20 steps of
               0.1; ``parallel.make_batched_closed_loop`` takes it.
rollouts_ip(N) → the same with the interior-point controller
               (``flagship_ip``'s settings).
hermite_simpson(N) → (ocp, cfg): config 6 (``examples/config6_hermite_
               simpson.yaml``) — Van der Pol, Hermite-Simpson defects, the
               Simpson cost (integral), |u| ≤ 2, dt 0.1, open loop.
hermite_simpson_unc(N) → (ocp, cfg): the same OCP on the uncompressed
               Hermite-Simpson grid (midpoints in the stage vector: nz 6,
               nc 4 on Van der Pol).
rollouts_hs(N) → (controller, plant, T_steps=40, dt=0.1): config 6 under a
               PredictiveController against the simulated Van der Pol.
move_blocking(N) → (ocp, cfg): config 1 with its controls blocked in ten
               blocks of N/10 intervals.
kalman_dual_mode(N) → (controller, plant, T_steps=60, dt=0.1, observer):
               config 5 of ``examples/config5_kalman_dual_mode.yaml`` — the
               double integrator measured in its first state with noise, a
               steady-state Kalman filter, MPC handing over to an LQR inside
               a terminal ball.
entry()      → (fn, example_args): the batched MPC solve on that config.
dryrun_multichip(n) → one sharded step of config 1 (N=8) over an n-rank
               mesh, in every rank of the job:

    torchrun --nproc-per-node N -m control_box_rst_tpu_torch.entry --dryrun-multichip
"""
from __future__ import annotations

import torch

from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype


# float32 interior-point settings, picked before the first chip run: the first
# candidate under which the JAX package's float32 solve and the port's own
# float32 solve of the first 64 lanes both converge (>= 0.99) and both stay
# within 1e-3 of the float64 oracle (tools/ip_calibration.py; PERF.md §2).
# A higher cap buys next to nothing on config 1: of 589,824 lanes of the
# benchmark's sweep (H100), all but two that converge do so within 70
# iterations (those two at 103 and 213), and the 622 that do not (0.105 %;
# position and velocity of one sign, |x0|∞ ≥ 0.69, controls on the bound)
# stall with μ at its floor and the stationarity residual at 7e-6 to 2e-5,
# the float32 floor, through 2000 iterations (PERF.md §7)
IP_F32_CONFIG1 = dict(tol=7e-6, max_iter=80)
IP_F32_CONSTRAINED_DI = dict(tol=1e-5, max_iter=200)
# float32 SQP settings of Van der Pol, configs 2 and 6: the stationarity
# residual stalls near 1e-4 (the ADMM dual floor at QP tolerance 1e-5)
VDP_F32_SQP = dict(tol_stat=1e-4, tol_feas=1e-5)
VDP_F32_QP = dict(max_iter=60, iters_per_round=30, tol=1e-5)


def flagship(N: int = 50, dtype=None, device=None):
    """Config-1 OCP: double integrator, quadratic cost, input bounds, H=N.
    The OCP's tensors are created as ``dtype`` (float32 unless asked) on
    ``device`` (``None`` means the card and raises when there is none)."""
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.ocp import (
        Bounds,
        CompositeCost,
        QuadraticFinalStateCost,
        QuadraticFormCost,
        finite_differences_grid,
        transcribe,
    )
    from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

    kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
    sys_ = DoubleIntegratorContinuous()
    grid = finite_differences_grid(N, fd_scheme="crank_nicolson")
    cost = CompositeCost(
        costs=(
            QuadraticFormCost(Q=torch.eye(2, **kw), R=0.1 * torch.eye(1, **kw)),
            QuadraticFinalStateCost(Qf=10.0 * torch.eye(2, **kw)),
        )
    )
    bounds = Bounds.unbounded(2, 1, **kw).with_u(-1.0, 1.0).with_dt(0.1, 0.1)
    ocp = transcribe(
        sys_, grid, cost, bounds=bounds, x0=torch.zeros(2, **kw), **kw
    )
    # float32-calibrated tolerances: the fused one-shot LTI path
    # (solvers/sqp.py) runs the whole solve in one kernel launch — recentered
    # ρ-rounds of 12 ADMM iterations with an in-kernel exact-KKT early exit
    # at (tol_stat, tol_feas)
    cfg = SQPConfig(
        max_iter=16,
        qp=QPConfig(max_iter=12, iters_per_round=12, rho=1.0, tol=1e-5),
        tol_stat=1e-4,
        tol_feas=1e-5,
    )
    return ocp, cfg


def flagship_lm(N: int = 50, dtype=None, device=None):
    """The config-1 OCP of ``flagship`` with the Levenberg-Marquardt backend's
    settings (``parallel.make_batched_lm_solver`` takes both)."""
    from control_box_rst_tpu_torch.solvers import LMConfig

    ocp, _ = flagship(N, dtype=dtype, device=device)
    return ocp, LMConfig(max_iter=60)


def flagship_ip(N: int = 50, dtype=None, device=None):
    """The config-1 OCP of ``flagship`` with the interior-point backend's
    float32 settings (``parallel.make_batched_solver`` takes both, as does
    ``parallel.make_batched_ip_solver``): ``IP_F32_CONFIG1``."""
    from control_box_rst_tpu_torch.solvers import IPConfig

    ocp, _ = flagship(N, dtype=dtype, device=device)
    return ocp, IPConfig(**IP_F32_CONFIG1)


def constrained_di(N: int = 25, dtype=None, device=None):
    """The constrained double integrator of the JAX package's IP test
    (``tests/test_ip_solver.py:37-51,73-92``): Crank–Nicolson finite
    differences, N intervals of dt 0.25 (pinned; the initial guess carries
    it: ``dt_init=0.25``), Q = I, R = 0.1, no terminal cost, |u| ≤ 1, the
    stage row x₂ ≥ −0.9 and the terminal equality x_N = 0 as general rows
    (ng = 2, nz = 4, nc = 2). Returns (ocp, SQPConfig, LMConfig, IPConfig);
    SQP takes the non-fused ADMM (general rows), LM and IP the
    block-tridiagonal kernel. ``dtype`` / ``device`` as in ``flagship``."""
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.ocp import (
        Bounds,
        QuadraticFormCost,
        finite_differences_grid,
        transcribe,
    )
    from control_box_rst_tpu_torch.ocp.constraints import (
        FunctionalStageConstraint,
        terminal_equality,
    )
    from control_box_rst_tpu_torch.solvers import IPConfig, LMConfig, SQPConfig

    kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
    ocp = transcribe(
        DoubleIntegratorContinuous(), finite_differences_grid(N),
        QuadraticFormCost(Q=torch.eye(2, **kw), R=0.1 * torch.eye(1, **kw)),
        bounds=Bounds.unbounded(2, 1, **kw).with_u(-1.0, 1.0),
        x0=torch.tensor([2.0, 0.0], **kw),
        stage_con=FunctionalStageConstraint(
            nineq=1, ineq_fn=lambda x, u: -x[..., 1:2] - 0.9),  # x₂ ≥ −0.9
        term_con=terminal_equality(2), **kw,
    )
    return ocp, SQPConfig(max_iter=30), LMConfig(max_iter=60), IPConfig(**IP_F32_CONSTRAINED_DI)


def vdp_ms(N: int = 20, dtype=None, device=None):
    """Config-2 OCP: Van der Pol, multiple shooting (RK4, one substep), box
    input bounds, H=N, with its solver settings. ``dtype`` / ``device`` as in
    ``flagship``."""
    from control_box_rst_tpu_torch.models import VanDerPolOscillator
    from control_box_rst_tpu_torch.ocp import (
        Bounds,
        CompositeCost,
        QuadraticFinalStateCost,
        QuadraticFormCost,
        multiple_shooting_grid,
        transcribe,
    )
    from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

    kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
    grid = multiple_shooting_grid(N, integrator="rk4", substeps=1)
    cost = CompositeCost(costs=(
        QuadraticFormCost(Q=torch.eye(2, **kw), R=0.1 * torch.eye(1, **kw)),
        QuadraticFinalStateCost(Qf=5.0 * torch.eye(2, **kw)),
    ))
    bounds = Bounds.unbounded(2, 1, **kw).with_u(-1.0, 1.0).with_dt(0.1, 0.1)
    ocp = transcribe(VanDerPolOscillator(), grid, cost, bounds=bounds,
                     x0=torch.zeros(2, **kw), **kw)
    cfg = SQPConfig(max_iter=20, qp=QPConfig(**VDP_F32_QP), **VDP_F32_SQP)
    return ocp, cfg


def time_optimal(N: int = 20, dtype=None, device=None):
    """Config-3 OCP: uniform-grid time-optimal control of the double
    integrator, dt a decision variable tied across the intervals, x0 = [1.5, 0]
    (a batch replaces it) to xf = 0 fully pinned, H=N, with its solver
    settings. Analytic optimum T* = 2√d from x0 = [d, 0]; Crank–Nicolson
    reproduces it exactly. ``make_batched_solver(ocp, cfg, dt_init=0.12)``
    starts from the reference's initial guess. ``dtype`` / ``device`` as in
    ``flagship``."""
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.ocp import (
        Bounds,
        MinimumTime,
        finite_differences_variable_grid,
        transcribe,
    )
    from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

    kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
    grid = finite_differences_variable_grid(N, fd_scheme="crank_nicolson")
    bounds = Bounds.unbounded(2, 1, **kw).with_u(-1.0, 1.0).with_dt(1e-3, 0.5)
    ocp = transcribe(
        DoubleIntegratorContinuous(), grid, MinimumTime(), bounds=bounds,
        x0=torch.tensor([1.5, 0.0], **kw), xf=torch.zeros(2, **kw),
        xf_fixed=torch.tensor([1.0, 1.0], **kw), **kw,
    )
    # backend 'fused' by name, as the reference asks for it: the QP of every
    # SQP iteration goes to the box-QP kernel (float32 only; a float64 solve
    # has to ask for 'plain')
    cfg = SQPConfig(
        max_iter=25,
        qp=QPConfig(max_iter=80, iters_per_round=40, tol=1e-5, backend="fused"),
        tol_stat=3e-4, tol_feas=1e-5,
    )
    return ocp, cfg


def nonuniform_ms_timeopt(N: int = 10, dtype=None, device=None):
    """Config-4 OCP (``tests/test_golden_nonuniform.py:_config4_ocp``): the
    double integrator on the non-uniform multiple-shooting grid (RK4, one
    substep, a free dt per interval), ``MinimumTime(weight=N, lsq_form=True)``
    — N·Σ dt_k², T*² at the optimum, where every dt_k = T*/N — |u| ≤ 1, dt in
    [1e-3, 0.5], x0 = [1.5, 0] (a batch replaces it) to xf = 0 fully pinned,
    with its float32 solver settings. Optimum T* = 2√d from x0 = [d, 0];
    ``make_batched_solver(ocp, cfg, dt_init=0.1)`` starts from the golden
    test's initial guess. ``dtype`` / ``device`` as in ``flagship``."""
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.ocp import (
        Bounds,
        MinimumTime,
        non_uniform_multiple_shooting_variable_grid,
        transcribe,
    )
    from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

    kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
    grid = non_uniform_multiple_shooting_variable_grid(N, integrator="rk4", substeps=1)
    bounds = Bounds.unbounded(2, 1, **kw).with_u(-1.0, 1.0).with_dt(1e-3, 0.5)
    ocp = transcribe(
        DoubleIntegratorContinuous(), grid, MinimumTime(weight=float(N), lsq_form=True),
        bounds=bounds, x0=torch.tensor([1.5, 0.0], **kw), xf=torch.zeros(2, **kw),
        xf_fixed=torch.tensor([1.0, 1.0], **kw), **kw,
    )
    # float32 settings, picked with the JAX package's own float32 solve
    # (tools/config4_calibration.py): config 3's, which reach T* to 4e-7
    cfg = SQPConfig(
        max_iter=25,
        qp=QPConfig(max_iter=80, iters_per_round=40, tol=1e-5),
        tol_stat=3e-4, tol_feas=1e-5,
    )
    return ocp, cfg


def nonuniform_ms_timeopt_adaptive(N: int = 15, dtype=None, device=None):
    """Config 4 under MPC with grid adaptation, as the golden test of case 9
    builds it (``tests/test_golden_nonuniform.py:180-190``): the config-4 OCP
    on N = 15 intervals, ``RedundantControls(epsilon=1e-3, backup=1, n_min=2,
    n_max=N)``, an initial active horizon of 10, no warm-start shift; the
    simulated double integrator; 25 steps of 0.1. Returns (controller, plant,
    T_steps, dt); only the SQP settings differ from the golden test's float64
    ones (``nonuniform_ms_timeopt``'s float32 settings). ``dtype`` /
    ``device`` as in ``flagship``; the controller runs there."""
    from control_box_rst_tpu_torch.control import PredictiveController
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.ocp import RedundantControls
    from control_box_rst_tpu_torch.sim import SimulatedPlant

    ocp, cfg = nonuniform_ms_timeopt(N, dtype=dtype, device=device)
    ctrl = PredictiveController(
        nx=2, nu=1, ocp=ocp, dt=0.1, cfg=cfg, warm_start_shift=False,
        adaptation=RedundantControls(epsilon=1e-3, backup=1, n_min=2, n_max=N),
        n_active_init=10, device=device, dtype=dtype,
    )
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    return ctrl, plant, 25, 0.1


def rollouts(N: int = 50, dtype=None, device=None):
    """Config 5: closed-loop MPC of the config-1 OCP (``flagship(N)``) against
    the simulated continuous double integrator, as the reference's scenario
    benchmark builds it. Returns (controller, plant, T_steps=20, dt=0.1).
    ``dtype`` / ``device`` as in ``flagship``; the controller runs there."""
    from control_box_rst_tpu_torch.control import PredictiveController
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.sim import SimulatedPlant

    ocp, cfg = flagship(N, dtype=dtype, device=device)
    ctrl = PredictiveController(
        nx=2, nu=1, ocp=ocp, dt=0.1, cfg=cfg, device=device, dtype=dtype)
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    return ctrl, plant, 20, 0.1


def rollouts_ip(N: int = 50, dtype=None, device=None):
    """Config 5 under the interior-point controller: ``rollouts``' OCP, plant
    and steps, ``solver='ip'`` with ``flagship_ip``'s settings."""
    ctrl, plant, T, dt = rollouts(N, dtype=dtype, device=device)
    _, ip_cfg = flagship_ip(N, dtype=dtype, device=device)
    return ctrl.replace(solver="ip", ip_cfg=ip_cfg), plant, T, dt


def _config6_ocp(grid, dtype, device):
    from control_box_rst_tpu_torch.models import VanDerPolOscillator
    from control_box_rst_tpu_torch.ocp import (
        Bounds,
        CompositeCost,
        QuadraticFinalStateCost,
        QuadraticFormCost,
        transcribe,
    )

    kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
    # the YAML's `integral: true`: the Simpson rule applies to the whole
    # composite (the final-state term has no stage part)
    cost = CompositeCost(costs=(
        QuadraticFormCost(Q=torch.eye(2, **kw), R=0.1 * torch.eye(1, **kw), integral=True),
        QuadraticFinalStateCost(Qf=5.0 * torch.eye(2, **kw)),
    ), integral=True)
    bounds = Bounds.unbounded(2, 1, **kw).with_u(-2.0, 2.0).with_dt(0.1, 0.1)
    return transcribe(VanDerPolOscillator(), grid, cost, bounds=bounds,
                      x0=torch.tensor([1.0, 0.5], **kw), **kw)


def hermite_simpson(N: int = 20, dtype=None, device=None):
    """Config 6 (``examples/config6_hermite_simpson.yaml``): Van der Pol on
    ``finite_differences_grid(N, 'hermite_simpson', cost_integration=
    'hermite_simpson')``, Q = I, R = 0.1 integral (Simpson rule on the
    Hermite midpoint), Qf = 5·I, |u| ≤ 2, dt pinned at 0.1, x0 = [1, 0.5]
    (a batch replaces it), with its float32 solver settings: config 2's
    tolerances and 20 SQP iterations (for a cold start from the straight
    line; the YAML's 10 is the closed loop's per-step budget,
    ``rollouts_hs``). ``dtype`` / ``device`` as in ``flagship``."""
    from control_box_rst_tpu_torch.ocp import finite_differences_grid
    from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

    grid = finite_differences_grid(N, fd_scheme="hermite_simpson",
                                   cost_integration="hermite_simpson")
    cfg = SQPConfig(max_iter=20, qp=QPConfig(**VDP_F32_QP), **VDP_F32_SQP)
    return _config6_ocp(grid, dtype, device), cfg


def hermite_simpson_unc(N: int = 20, dtype=None, device=None):
    """Config 6's OCP on ``hermite_simpson_uncompressed_grid(N)``: the
    interval midpoints are decision variables in the stage vector (w_k =
    [x; u; dt; xm], nz 6) with their interpolation rows (nc 4), and the
    Simpson cost evaluates them; the solution equals ``hermite_simpson``'s.
    Settings as there."""
    from control_box_rst_tpu_torch.ocp import hermite_simpson_uncompressed_grid
    from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

    cfg = SQPConfig(max_iter=20, qp=QPConfig(**VDP_F32_QP), **VDP_F32_SQP)
    return _config6_ocp(hermite_simpson_uncompressed_grid(N), dtype, device), cfg


def rollouts_hs(N: int = 20, dtype=None, device=None):
    """Config 6 under MPC, as its YAML runs it: ``hermite_simpson(N)``'s OCP
    with the YAML's 10 SQP iterations a step (float32 tolerances as there)
    in a ``PredictiveController`` against the simulated Van der Pol (RK4, 4
    substeps, no noise), 40 steps of 0.1. Returns (controller, plant,
    T_steps, dt); ``dtype`` / ``device`` as in ``flagship``."""
    from control_box_rst_tpu_torch.control import PredictiveController
    from control_box_rst_tpu_torch.models import VanDerPolOscillator
    from control_box_rst_tpu_torch.sim import SimulatedPlant

    ocp, cfg = hermite_simpson(N, dtype=dtype, device=device)
    ctrl = PredictiveController(
        nx=2, nu=1, ocp=ocp, dt=0.1, cfg=cfg.replace(max_iter=10), device=device, dtype=dtype)
    return ctrl, SimulatedPlant(system=VanDerPolOscillator()), 40, 0.1


def move_blocking(N: int = 50, dtype=None, device=None):
    """Config 1 (``flagship(N)``'s OCP and settings) on
    ``move_blocking_grid(N, [N // 10] * 10)``: u_{k+1} = u_k inside each of
    ten blocks, as tie rows (nc = nx + nu = 3). LTI with a constant Hessian,
    so the solve is the one-shot in the box-QP kernel on one shared copy of
    Hd/J/K. ``dtype`` / ``device`` as in ``flagship``."""
    from control_box_rst_tpu_torch.ocp import move_blocking_grid

    if N % 10:
        raise ValueError(f"N={N}: ten blocks of equal length need N divisible by 10")
    ocp, cfg = flagship(N, dtype=dtype, device=device)
    # the tie rows are held to tol_feas: 1e-6 keeps a block's controls equal to
    # 1e-6 in float32. At config 1's 1e-5 they spread up to 2.5e-6 in the JAX
    # package's own float32 run too (tools/config6_calibration.py, move_blocking)
    return ocp.replace(grid=move_blocking_grid(N, [N // 10] * 10)), cfg.replace(tol_feas=1e-6)


def kalman_dual_mode(N: int = 30, dtype=None, device=None):
    """Config 5 of ``examples/config5_kalman_dual_mode.yaml``: the double
    integrator (CN, N intervals of 0.1, Q = I, R = 0.1, Qf = 10·I, |u| ≤ 1 —
    config 1's OCP at N = 30) under a ``DualModeController``: MPC (the YAML's
    8 SQP iterations a step, config 1's float32 tolerances) hands over to an
    LQR (Q = I, R = 1) inside the ball xᵀ S x ≤ γ (S = I, γ = 0.09), latched.
    The plant (RK4, 4 substeps) is measured in its first state with output
    noise of std 0.02; a steady-state Kalman filter (V = 4e-4, W its 1e-3·I
    default) on the ZOH-discretized linearization reconstructs the state.
    Returns (controller, plant, T_steps=60, dt=0.1, observer); the noise is
    drawn from the generator the rollout is given. ``dtype`` / ``device`` as
    in ``flagship``."""
    from control_box_rst_tpu_torch.control import (
        DualModeController,
        LqrController,
        PredictiveController,
    )
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.sim import GaussianNoise, SimulatedPlant
    from control_box_rst_tpu_torch.sim.observer import SteadyStateKalmanObserver

    dtype, device = resolve_dtype(dtype), resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    ocp, cfg = flagship(N, **kw)
    ocp = ocp.replace(bc=ocp.bc.replace(x0=torch.tensor([1.0, 0.0], **kw)))
    system = DoubleIntegratorContinuous()
    mpc = PredictiveController(nx=2, nu=1, ocp=ocp, dt=0.1, cfg=cfg.replace(max_iter=8), **kw)
    local = LqrController.from_system(system, torch.eye(2), torch.eye(1), **kw)
    ctrl = DualModeController(
        nx=2, nu=1, global_controller=mpc, local_controller=local,
        S=torch.eye(2, **kw), gamma=0.09, xf=torch.zeros(2, **kw), latch=True)
    plant = SimulatedPlant(system=system, output_kind="first",
                           output_noise=GaussianNoise(std=0.02))
    observer = SteadyStateKalmanObserver.from_plant(
        plant, 0.1, V=torch.tensor([[4e-4]], dtype=torch.float64), **kw)
    return ctrl, plant, 60, 0.1, observer


def entry(device=None):
    """Batched H=50 SQP MPC solve. ``device=None`` means the card."""
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    device = resolve_device(device)
    ocp, cfg = flagship(device=device)
    batched = make_batched_solver(ocp, cfg, dt_init=0.1, device=device)

    def fn(x0s):
        U, obj, status, iters = batched(x0s)
        return U

    x0s = torch.zeros((8, 2), dtype=torch.float32, device=device)
    x0s[:, 0] = 1.0
    return fn, (x0s,)


def dryrun_multichip(n_devices: int, device_type=None) -> None:
    """Shard the batched MPC solve of config 1 (N=8) over an n-rank mesh and
    run one step on 2n lanes. Called in every rank of an n-rank job (the
    ``torchrun`` environment, a group the caller made, or one rank alone);
    ``device_type=None`` means the card. Rank 0 prints one line."""
    import torch.distributed as dist

    from control_box_rst_tpu_torch.parallel import make_batched_solver, make_mesh, shard_batch
    from control_box_rst_tpu_torch.parallel.mesh import gather_batch, mesh_device

    mesh = make_mesh(device_type=device_type)
    if mesh.size() != n_devices:
        raise RuntimeError(f"expected a {n_devices}-rank mesh, got {mesh.size()} ranks")
    ocp, cfg = flagship(N=8, device=mesh_device(mesh))  # tiny shapes for the dry run
    solver = make_batched_solver(ocp, cfg, dt_init=0.1, mesh=mesh)
    B = 2 * n_devices
    x0s = torch.linspace(-1.0, 1.0, B)[:, None] * torch.ones((B, 2))
    U, obj, status, iters = solver(shard_batch(x0s, mesh))
    if tuple(U.shape) != (B, 8, 1) or tuple(U.to_local().shape) != (2, 8, 1):
        raise AssertionError(f"U {tuple(U.shape)}, local {tuple(U.to_local().shape)}")
    objectives = gather_batch(obj)[:4].cpu().numpy()
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: {n_devices} ranks ({dist.get_backend()}), batch {B}, "
              f"objectives {objectives.round(4)}", flush=True)


if __name__ == "__main__":
    import argparse
    import os

    ap = argparse.ArgumentParser(description="Entry points of the port.")
    ap.add_argument("--dryrun-multichip", action="store_true",
                    help="one sharded config-1 step over the ranks of this job")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the mesh's device type (default: the card)")
    opts = ap.parse_args()
    if opts.dryrun_multichip:
        import torch.distributed as dist

        dryrun_multichip(int(os.environ.get("WORLD_SIZE", 1)), opts.device)
        dist.destroy_process_group()
