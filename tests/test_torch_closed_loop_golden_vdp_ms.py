"""PyTorch port vs the C++ reference: the closed loop of
``tests/golden/closed_loop_vdp_ms.tsv``.

Van der Pol, unconstrained, on the multiple-shooting grid (RK4, one
substep), N=20, 60 steps from [1, 0.5]; float64, the plain backend, the
settings and the tolerance of ``tests/test_golden_parity.py`` (2e-3 on u and
x). One golden per file: a closed loop takes about a minute of eager float64
on one CPU thread, and the test runner hands each file to one worker.
"""
import numpy as np
import torch

from control_box_rst_tpu_torch.ocp import multiple_shooting_grid

from torch_golden_util import load_golden, run_golden_case

torch.set_num_threads(1)


def test_closed_loop_matches_cpp_reference():
    _, x_ref, u_ref = load_golden("closed_loop_vdp_ms.tsv")
    grid = multiple_shooting_grid(20, integrator="rk4", substeps=1)
    res = run_golden_case("van_der_pol", grid, 5.0, [1.0, 0.5],
                          T_steps=60, sqp_max_iter=20)
    u_err = np.max(np.abs(res.u - u_ref))
    x_err = np.max(np.abs(res.x_true[:-1] - x_ref))
    assert u_err < 2e-3, f"control max err {u_err}"
    assert x_err < 2e-3, f"state max err {x_err}"
