"""The port's loader against the goldens of ``tools/master_golden.py`` that
the example files do not cover, float64 on the CPU:

- the zoo (``tests/golden/torch_master_zoo.npz``): one open-loop solve of
  each of the twelve registered systems (multiple shooting, RK4, N 20, the
  quadratic cost, each system's own dims; the configs are stored in the
  golden) through the port's ``run_experiment``: the planned controls and
  states within 1e-6 of the JAX package's float64 run, which converged on
  every system;
- the loader's other solvers (``tests/golden/torch_master_solvers.npz``):
  config 1's YAML with ``solver: {type: ip}`` and ``{type: lm}``, cut to
  ``T_steps`` 2 of the golden's 10: the applied controls and plant states
  within 1e-6, the same iteration counts, and IP's controls in the box.
"""
import json

import jax  # noqa: F401 (the test configuration: CPU, x64)
import numpy as np
import pytest
import torch

from control_box_rst_tpu_torch.core import config as tc

from torch_master_util import F64, GOLDEN_DIR, TOL, values

torch.set_num_threads(1)
ZOO = np.load(GOLDEN_DIR / "torch_master_zoo.npz")
SOLVERS = np.load(GOLDEN_DIR / "torch_master_solvers.npz")
ZOO_NAMES = sorted({k.split("/")[0] for k in ZOO.files})


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_zoo_open_loop_matches_the_golden(name):
    cfg = json.loads(str(ZOO[f"{name}/config"]))
    assert bool(ZOO[f"{name}/converged"])
    rec = tc.run_experiment(cfg, **F64)
    np.testing.assert_allclose(values(rec, "planned_controls"), ZOO[f"{name}/u"], rtol=0, atol=TOL)
    np.testing.assert_allclose(values(rec, "planned_states"), ZOO[f"{name}/x"], rtol=0, atol=TOL)


@pytest.mark.parametrize("solver", ["ip", "lm"])
def test_loader_solvers_match_the_golden(solver):
    key = f"config1_{solver}"
    cfg = json.loads(str(SOLVERS[f"{key}/config"]))
    cfg["experiment"]["T_steps"] = 2
    rec = tc.run_experiment(cfg, **F64)
    u, x = values(rec, "applied_controls"), values(rec, "plant_states")
    np.testing.assert_allclose(u, SOLVERS[f"{key}/u"][:2], rtol=0, atol=TOL)
    np.testing.assert_allclose(x, SOLVERS[f"{key}/x"][:3], rtol=0, atol=TOL)
    np.testing.assert_array_equal(values(rec, "controller/sqp_iters"),
                                  SOLVERS[f"{key}/sqp_iters"][:2])
    if solver == "ip":
        assert np.abs(u).max() <= 1.0 + 1e-9
