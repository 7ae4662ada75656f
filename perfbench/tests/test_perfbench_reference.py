"""The plain reference agrees with the port's plain float64 path at a tiny
size (open loop and closed loop), and with the f64 oracles of the JAX
package kept as golden files at the cells' own horizons."""
import json
import pathlib

import numpy as np
import pytest
import torch

from control_box_rst_tpu_torch import entry
from control_box_rst_tpu_torch.parallel import make_batched_closed_loop, make_batched_solver
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig
from perfbench import check
from perfbench.reference import problem, solve

ROOT = pathlib.Path(__file__).resolve().parents[2]
TIGHT = SQPConfig(max_iter=60, qp=QPConfig(max_iter=4000, iters_per_round=50, tol=1e-11,
                                           backend="plain"), tol_stat=1e-9, tol_feas=1e-10)
X0 = torch.tensor([[0.9, -0.7], [-0.5, 0.8], [1.4, 1.2], [-1.3, -0.2]], dtype=torch.float64)


def config(name, N=None):
    c = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    if N is not None:
        c["grid"] = dict(c["grid"], N=N)
    return c


@pytest.mark.parametrize("name,builder", [("di_h50", entry.flagship), ("vdp_ms_h20", entry.vdp_ms)])
def test_open_loop_agrees_with_the_port_in_float64(name, builder):
    ocp, _ = builder(10, dtype=torch.float64, device="cpu")
    solver = make_batched_solver(ocp, TIGHT, dt_init=0.1, device="cpu", dtype=torch.float64)
    U, _, status, _ = solver(X0)
    ref = check.reference(config(name, 10), "sweep", X0, 0, "cpu")
    assert bool((status == 1).all()) and bool(ref["converged"].all())
    assert (U - ref["U"]).abs().max().item() < 1e-8


def test_closed_loop_agrees_with_the_port_in_float64():
    ctrl, plant, _, dt = entry.rollouts(10, dtype=torch.float64, device="cpu")
    roll = make_batched_closed_loop(ctrl.replace(cfg=TIGHT), plant, 5, dt, device="cpu",
                                    dtype=torch.float64)
    res = roll(X0[:2])
    ref = check.reference(config("di_h50", 10), "rollouts", X0[:2], 5, "cpu")
    assert (res.u - ref["u"]).abs().max().item() < 1e-8
    assert (res.x_true - ref["x"]).abs().max().item() < 1e-8


@pytest.mark.parametrize("name,golden", [("di_h50", "torch_flagship_oracle_N50.npz"),
                                         ("vdp_ms_h20", "torch_vdp_ms_oracle_N20.npz")])
def test_the_cells_horizons_agree_with_the_golden_oracles(name, golden):
    g = np.load(ROOT / "tests" / "golden" / golden)
    x0 = torch.tensor(g["x0s"][:16], dtype=torch.float64)
    U, ok = solve.solve(problem.build(config(name)), x0)
    assert bool(ok.all())
    assert np.abs(U.numpy() - g["U"][:16]).max() < 1e-6


def test_a_non_finite_answer_reads_infinite():
    ref = {"U": torch.zeros((2, 3, 1), dtype=torch.float64)}
    ans = {"U": torch.tensor([[[0.0], [float("nan")], [0.0]], [[0.0]] * 3])}
    assert check.numbers(ans, ref, "sweep")["u_gap"] == float("inf")
