"""The port against the f64 oracle golden file, on the CPU in float64.

tests/golden/torch_flagship_oracle_N50.npz holds the JAX package's f64 oracle
(tools/oracle_solve.py, unmodified) on the first 64 of the benchmark's initial
states (numpy default_rng(0), uniform(-1, 1), float32): x0s, U, obj,
converged. Here the port solves 4 of those lanes at N=50 with the non-fused
backend at the oracle's own settings; max |U − U_oracle| <= 1e-6 (both sides
stop at KKT tolerances 1e-8 / 1e-9 with QP tolerance 1e-10).
"""
import pathlib

import numpy as np
import torch

from control_box_rst_tpu_torch.entry import flagship
from control_box_rst_tpu_torch.parallel import make_batched_solver
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_flagship_oracle_N50.npz"


def test_golden_file_is_the_benchmarks_inputs():
    gold = np.load(GOLDEN)
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-1.0, 1.0, size=(32768, 2)).astype(np.float32)
    np.testing.assert_array_equal(gold["x0s"], x0s[:64])
    assert gold["U"].shape == (64, 50, 1) and gold["U"].dtype == np.float64
    assert gold["converged"].all() and np.isfinite(gold["obj"]).all()
    assert np.abs(gold["U"]).max() <= 1.0 + 1e-8


def test_port_f64_matches_oracle_golden():
    gold = np.load(GOLDEN)
    lanes = [0, 1, 2, 3]
    ocp, _ = flagship(N=50, dtype=torch.float64, device="cpu")
    cfg = SQPConfig(
        max_iter=50,
        qp=QPConfig(max_iter=4000, iters_per_round=100, rho=1.0, tol=1e-10,
                    backend="plain"),
        tol_stat=1e-8,
        tol_feas=1e-9,
    )
    solver = make_batched_solver(ocp, cfg, dt_init=0.1, device="cpu", dtype=torch.float64)
    U, obj, status, iters = solver(gold["x0s"][lanes].astype(np.float64))
    assert U.dtype == torch.float64
    assert bool((status == 1).all())
    assert float(np.abs(U.numpy() - gold["U"][lanes]).max()) <= 1e-6
    np.testing.assert_allclose(obj.numpy(), gold["obj"][lanes], rtol=1e-8)
