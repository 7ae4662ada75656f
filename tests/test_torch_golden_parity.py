"""The port's float64 SQP on the CPU against the C++ reference's open-loop
plans (``tests/golden/``, made by ``tools/golden_gen.cpp``), with the
problems, settings and tolerances of ``tests/test_golden_parity.py``:

- ``plan_double_integrator.tsv`` and ``plan_van_der_pol.tsv``
  (``:102-140``): the whole planned U and X within 1e-4;
- ``closed_loop_di_timeopt.tsv.plan`` (``:224-256``): the time-optimal plan
  on the variable-dt grid, dt* within 1e-3 of the reference's, U within 1e-2
  (the same bang-bang switch);
- ``closed_loop_vdp_ms_multi.tsv.plan`` (``:317-356``): the reference's
  multi-control shooting plan against the port's single-control shooting
  grid, U and the shooting-node states within 1e-3.

The time-optimal closed loop ``closed_loop_di_timeopt.tsv`` (``:259-314``)
is not here: 40 steps of 1000-iteration QPs take about 20 minutes of eager
float64 on one CPU thread.
"""
import numpy as np
import pytest
import torch

from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous, VanDerPolOscillator
from control_box_rst_tpu_torch.ocp import (
    Bounds,
    CompositeCost,
    MinimumTime,
    QuadraticFinalStateCost,
    QuadraticFormCost,
    Trajectory,
    finite_differences_grid,
    finite_differences_variable_grid,
    multiple_shooting_grid,
    transcribe,
)
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig, sqp_solve

from test_golden_parity import _load_plan, _load_plan_generic
from torch_port_util import to_np

torch.set_num_threads(1)
KW = dict(dtype=torch.float64, device="cpu")
t64 = lambda a: torch.tensor(a, **KW)


def _cost(Q_scale, Qf_scale):
    return CompositeCost(costs=(
        QuadraticFormCost(Q=Q_scale * torch.eye(2, **KW), R=0.1 * torch.eye(1, **KW)),
        QuadraticFinalStateCost(Qf=Qf_scale * torch.eye(2, **KW)),
    ))


@pytest.mark.parametrize(
    "plan_file,system,N,Qf_scale,x0",
    [
        ("plan_double_integrator.tsv", DoubleIntegratorContinuous, 50, 10.0, [1.0, 0.0]),
        ("plan_van_der_pol.tsv", VanDerPolOscillator, 20, 5.0, [1.0, 0.5]),
    ],
)
def test_open_loop_plan_matches_cpp_reference(plan_file, system, N, Qf_scale, x0):
    X_ref, U_ref = _load_plan(plan_file)
    ocp = transcribe(system(), finite_differences_grid(N, "crank_nicolson"),
                     _cost(1.0, Qf_scale), x0=t64(x0), **KW)
    traj0 = Trajectory.linear_interp(t64(x0), torch.zeros(2, **KW), N, 1, 0.1)
    res = sqp_solve(ocp, traj0, SQPConfig(max_iter=20, qp=QPConfig(max_iter=2000, tol=1e-12)))
    u_err = np.max(np.abs(to_np(res.traj.U) - U_ref))
    x_err = np.max(np.abs(to_np(res.traj.X) - X_ref))
    assert u_err < 1e-4, f"plan control max err {u_err}"
    assert x_err < 1e-4, f"plan state max err {x_err}"


def test_time_optimal_plan_matches_cpp_reference():
    X_ref, U_ref, TX = _load_plan_generic("closed_loop_di_timeopt.tsv.plan")
    dt_ref_golden = TX[1] - TX[0]
    grid = finite_differences_variable_grid(20, fd_scheme="crank_nicolson")
    bounds = Bounds.unbounded(2, 1, **KW).with_u(-1.0, 1.0).with_dt(1e-3, 0.5)
    ocp = transcribe(
        DoubleIntegratorContinuous(), grid, MinimumTime(), bounds=bounds,
        x0=t64([1.5, 0.0]), xf=torch.zeros(2, **KW), xf_fixed=t64([1.0, 1.0]), **KW,
    )
    traj0 = Trajectory.linear_interp(t64([1.5, 0.0]), torch.zeros(2, **KW), 20, 1, 0.15)
    cfg = SQPConfig(max_iter=50, qp=QPConfig(max_iter=1000, tol=1e-10),
                    tol_stat=1e-6, tol_feas=1e-8)
    res = sqp_solve(ocp, traj0, cfg)
    dt_star = float(res.traj.dts[0])
    assert abs(dt_star - dt_ref_golden) < 1e-3, f"dt* {dt_star} vs reference {dt_ref_golden}"
    u_err = np.max(np.abs(to_np(res.traj.U) - U_ref[:20]))
    assert u_err < 1e-2, f"plan control err {u_err}"  # bang-bang, same switch


def test_multi_control_shooting_subsumption():
    X_ref, U_ref, TX = _load_plan_generic("closed_loop_vdp_ms_multi.tsv.plan")
    assert X_ref.shape[0] == 6  # states at shooting nodes only
    U_ref = U_ref[:20]          # last row is the TimeSeries end repeat
    grid = multiple_shooting_grid(20, integrator="rk4", substeps=1)
    ocp = transcribe(VanDerPolOscillator(), grid, _cost(0.0, 5.0), x0=t64([1.0, 0.5]), **KW)
    traj0 = Trajectory.linear_interp(t64([1.0, 0.5]), torch.zeros(2, **KW), 20, 1, 0.1)
    cfg = SQPConfig(max_iter=30, qp=QPConfig(max_iter=1000, tol=1e-12),
                    tol_stat=1e-7, tol_feas=1e-9)
    res = sqp_solve(ocp, traj0, cfg)
    u_err = np.max(np.abs(to_np(res.traj.U) - U_ref))
    assert u_err < 1e-3, f"control err vs multi-control MS {u_err}"
    x_err = np.max(np.abs(to_np(res.traj.X)[::4] - X_ref))
    assert x_err < 1e-3, f"shooting-node state err {x_err}"
