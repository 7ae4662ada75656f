"""The config loader's fused SQP path rehearsed on the CPU: K1 from its
(4, 2) host build (``tools/cuda_host_shim``, as in
``test_torch_kernel_rehearsal.py``), driven by the wrapper's own launch code
under ``run_experiment`` on config 1's YAML, so that a loader that routes
around ``'fused'`` fails here and not only on the card. Skipped where there
is no g++.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak

from test_torch_kernel_rehearsal import _shim_build

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def admm(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the CUDA sources cannot be rehearsed on this machine")
    out = tmp_path_factory.mktemp("cuda_host_shim")
    lib = ctypes.CDLL(str(_shim_build()(ak.SOURCE, out / "libadmm_4_2.so", ["-DNZ=4", "-DNC=2"])))
    ak.declare(lib, 4, 2)
    return {(4, 2): lib}


def test_loader_fused_path_through_the_host_kernel(admm, monkeypatch):
    """The config loader's fused SQP path: config 1's YAML (1 of its 70
    steps: the one-shot on the hoisted Hd/J/K, then the outer iterations)
    through ``run_experiment`` in float32, the backend resolved as on the
    card (``'fused'``: float32, no general rows) and K1 launched from the
    (4, 2) host build by its wrapper's own launch code: one launch per
    lock-step SQP iteration (the recorded ``controller/sqp_iters`` and the
    solver's own count), the controls within 1e-3 of the same run through
    the plain backend, as the card's fused-vs-plain gate holds them."""
    import pathlib

    import yaml

    from control_box_rst_tpu_torch.control import predictive
    from control_box_rst_tpu_torch.core import config as tc

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "config1_double_integrator.yaml"
    cfg = yaml.safe_load(path.read_text())
    cfg["experiment"]["T_steps"] = 1
    f32 = dict(device="cpu", dtype=torch.float32)
    plain = tc.run_experiment(cfg, **f32)

    real_resolve, real_sqp = predictive.resolve_qp_backend, predictive.sqp_solve
    calls, iterations = [], []

    def resolve_as_on_the_card(cfg, ng, device, dtype):
        return real_resolve(cfg, ng, "cuda", dtype)

    def sqp_solve(*args, **kw):
        res = real_sqp(*args, **kw)
        iterations.append(int(res.iterations.max()))
        return res

    def launch(*args, **kw):
        dims = ak._check_args(args)
        calls.append((dims, kw["tol_stat"] > 0.0))
        keys = ("n_rounds", "iters", "tol", "sigma", "alpha", "rho_eq_scale", "rho_min",
                "rho_max", "tol_stat", "tol_feas")
        return ak._launch_smem(admm[dims[2], dims[3]], "boxqp_solve", args, dims,
                               tuple(kw[k] for k in keys), 0)

    monkeypatch.setattr(predictive, "resolve_qp_backend", resolve_as_on_the_card)
    monkeypatch.setattr(predictive, "sqp_solve", sqp_solve)
    monkeypatch.setattr(ak, "boxqp_solve", launch)
    rec = tc.run_experiment(cfg, **f32)
    sqp_iters = rec.get("controller/sqp_iters")["values"]
    assert len(calls) == int(sqp_iters.sum()) == sum(iterations) > 0
    # the first launch is the one-shot (its in-kernel KKT exit on)
    assert calls[0] == ((1, 51, 4, 2), True)
    assert all(c == ((1, 51, 4, 2), False) for c in calls[1:])
    np.testing.assert_allclose(rec.get("applied_controls")["values"],
                               plain.get("applied_controls")["values"], rtol=0, atol=1e-3)
