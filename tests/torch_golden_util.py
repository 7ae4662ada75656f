"""Closed-loop runs of the port against the C++ reference goldens of
``tests/golden/`` (made by ``tools/golden_gen.cpp``; read as
``tests/test_golden_parity.py`` reads them). Needs neither JAX nor a card."""
import os

import numpy as np
import torch

from control_box_rst_tpu_torch.control import PredictiveController
from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous, VanDerPolOscillator
from control_box_rst_tpu_torch.ocp import (
    Bounds,
    CompositeCost,
    QuadraticFinalStateCost,
    QuadraticFormCost,
    transcribe,
)
from control_box_rst_tpu_torch.sim import SimulatedPlant, run_closed_loop
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
KW = dict(dtype=torch.float64, device="cpu")
SYSTEMS = {"double_integrator": DoubleIntegratorContinuous, "van_der_pol": VanDerPolOscillator}


def load_golden(name):
    """(t [T], x [T, p], u [T, q]) of a closed-loop golden file."""
    path = os.path.join(GOLDEN_DIR, name)
    with open(path) as f:
        header = f.readline().split()
    p = int(header[header.index("p") + 1])
    q = int(header[header.index("q") + 1])
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1:1 + p], data[:, 1 + p:1 + p + q]


def run_golden_case(system, grid, Qf_scale, x0, T_steps, sqp_max_iter, u_max=None):
    """The port's closed loop of a golden case, float64 on the CPU: Q = I,
    R = 0.1, Qf = Qf_scale·I, the plain backend with the goldens' QP
    settings (1000 iterations, tolerance 1e-12), 0.1 s steps. Returns the
    ``ClosedLoopResult`` as numpy (unbatched)."""
    cost = CompositeCost(costs=(
        QuadraticFormCost(Q=torch.eye(2, **KW), R=0.1 * torch.eye(1, **KW)),
        QuadraticFinalStateCost(Qf=Qf_scale * torch.eye(2, **KW)),
    ))
    bounds = Bounds.unbounded(2, 1, **KW)
    if u_max is not None:
        bounds = bounds.with_u(-u_max, u_max)
    sys_ = SYSTEMS[system]()
    ocp = transcribe(sys_, grid, cost, bounds=bounds, x0=torch.zeros(2), **KW)
    ctrl = PredictiveController(
        nx=2, nu=1, ocp=ocp, dt=0.1,
        cfg=SQPConfig(max_iter=sqp_max_iter, qp=QPConfig(max_iter=1000, tol=1e-12)), **KW)
    res = run_closed_loop(SimulatedPlant(system=sys_), ctrl,
                          torch.tensor(x0, dtype=torch.float64), T_steps, 0.1)
    return type(res)(*(a.numpy() for a in res[:-1]),
                     info={k: v.numpy() for k, v in res.info.items()})
