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
entry()      → (fn, example_args): the batched MPC solve on that config.
"""
from __future__ import annotations

import torch

from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype


# float32 interior-point settings, picked before the first chip run: the first
# candidate under which the JAX package's float32 solve and the port's own
# float32 solve of the first 64 lanes both converge (>= 0.99) and both stay
# within 1e-3 of the float64 oracle (tools/ip_calibration.py; PERF.md §2)
IP_F32_CONFIG1 = dict(tol=7e-6, max_iter=80)
IP_F32_CONSTRAINED_DI = dict(tol=1e-5, max_iter=200)


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
    float32 settings (``parallel.make_batched_ip_solver`` takes both):
    ``IP_F32_CONFIG1``."""
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
    # float32-calibrated: the stationarity residual stalls near 1e-4 (the
    # ADMM dual floor at QP tolerance 1e-5)
    cfg = SQPConfig(
        max_iter=20,
        qp=QPConfig(max_iter=60, iters_per_round=30, tol=1e-5),
        tol_stat=1e-4, tol_feas=1e-5,
    )
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
