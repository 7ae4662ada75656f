"""PyTorch port vs the C++ reference: the closed loop of
``tests/golden/closed_loop_di_bounded.tsv``.

The double integrator with |u| <= 1 active for a stretch, on the
Crank–Nicolson grid, N=50, 60 steps from [2, 0.5]; float64, the plain
backend, the settings and the tolerance of ``tests/test_golden_parity.py``
(1e-3 on u and x). One golden per file: a closed loop takes about a minute
of eager float64 on one CPU thread, and the test runner hands each file to
one worker.
"""
import numpy as np
import torch

from control_box_rst_tpu_torch.ocp import finite_differences_grid

from torch_golden_util import load_golden, run_golden_case

torch.set_num_threads(1)


def test_closed_loop_matches_cpp_reference():
    _, x_ref, u_ref = load_golden("closed_loop_di_bounded.tsv")
    grid = finite_differences_grid(50, fd_scheme="crank_nicolson")
    res = run_golden_case("double_integrator", grid, 10.0, [2.0, 0.5],
                          T_steps=60, sqp_max_iter=20, u_max=1.0)
    assert res.u.max() <= 1.0 + 1e-9 and res.u.min() >= -1.0 - 1e-9
    assert (np.abs(res.u) > 0.999).sum() >= 10  # the bound is active for a stretch
    u_err = np.max(np.abs(res.u - u_ref))
    x_err = np.max(np.abs(res.x_true[:-1] - x_ref))
    assert u_err < 1e-3, f"control max err {u_err}"
    assert x_err < 1e-3, f"state max err {x_err}"
