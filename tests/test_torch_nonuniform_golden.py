"""PyTorch port vs the C++ goldens of config 4 (golden cases 8 and 9,
``tests/golden/nonuniform_ms_timeopt*``), as ``tests/test_golden_nonuniform.py``
holds the JAX package to them: the reference's converged plan meets the
port's per-interval multiple-shooting defects to its own floor (< 1e-6) and
the port's objective of it is the reference's LSQ value (1e-10); the port's
SQP reaches the analytic optimum T*² = 6 (1e-6), with equal dts, strictly
below the C++ oracle's local minimum (8.83) on its own objective.

The case-9 closed-loop contract (25 MPC steps with the RedundantControls
adaptation) is not here: on this CPU one rollout of it takes ~105 s in
float32 through the box-QP kernel's plain version. ``chip_smoke.py`` holds
the card's run to it (phase ``nonuniform``).
"""
import numpy as np
import torch

from control_box_rst_tpu_torch import entry
from control_box_rst_tpu_torch.ocp import Trajectory
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig, sqp_solve

from test_golden_nonuniform import T_STAR, _load_plan
from torch_port_util import to_np

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def test_golden_cpp_plan_under_the_port_transcription():
    """(a) + (b): the C++ LM's converged plan (golden case 8) meets the port's
    per-interval shooting defects to its own floor, and the port's objective
    of it is the reference's LSQ value N·Σ dt_k²."""
    X, U, TX = _load_plan("nonuniform_ms_timeopt.tsv.plan")
    N = 10
    dts = np.diff(TX)
    ocp, _ = entry.nonuniform_ms_timeopt(N, **CPU64)
    W = ocp.pack(Trajectory(X=torch.as_tensor(X), U=torch.as_tensor(U[:N]),
                            dts=torch.as_tensor(dts)))
    assert float(ocp.interval_residuals(W).abs().max()) < 1e-6
    assert abs(float(ocp.objective_from_W(W)) - N * np.sum(dts ** 2)) < 1e-10


def test_golden_port_solver_reaches_the_analytic_optimum():
    """(c): from the straight line with dt = 0.1, the port's SQP (float64,
    the golden test's settings) reaches T*² = 6 with equal dts, below the
    C++ oracle's 8.83 on its own objective."""
    N = 10
    ocp, _ = entry.nonuniform_ms_timeopt(N, **CPU64)
    cfg = SQPConfig(max_iter=80, qp=QPConfig(max_iter=2000, tol=1e-12),
                    tol_stat=1e-8, tol_feas=1e-10)
    traj0 = Trajectory.linear_interp(ocp.bc.x0, ocp.bc.xf, N, 1, 0.1)
    res = sqp_solve(ocp, traj0, cfg)
    assert int(res.status) == 1 and float(res.feas_res) < 1e-8
    assert abs(float(res.objective) - T_STAR ** 2) < 1e-6
    _, _, TX = _load_plan("nonuniform_ms_timeopt.tsv.plan")
    obj_ref = N * np.sum(np.diff(TX) ** 2)
    assert obj_ref > 8.8 and float(res.objective) < obj_ref - 2.5
    np.testing.assert_allclose(to_np(res.traj.dts), T_STAR / N, atol=1e-6)
    assert abs(float(res.traj.dts.sum()) - T_STAR) < 1e-6
