"""Config 1 by interior point through the port's sweep entry, on the CPU:

  - ``make_batched_solver`` with an ``IPConfig`` is the straight-line IP solve
    of ``make_batched_ip_solver``, bit for bit (N=12, float32, 8 lanes), and
    refuses a mesh;
  - the port's IP in float64 (``IPConfig()``: tol 1e-8) agrees in U with the
    benchmark's plain float64 reference (``perfbench/reference``: single
    shooting, projected Gauss-Newton) on seeded x0 of config 1 at N=50, to a
    tolerance the float32 IP solve of the same lanes misses;
  - the benchmark's configuration ``di_h50_ip`` states the port's float32 IP
    settings (``entry.IP_F32_CONFIG1``).
"""
import json
import pathlib

import pytest
import torch

from control_box_rst_tpu_torch import entry
from control_box_rst_tpu_torch.parallel import make_batched_ip_solver, make_batched_solver
from control_box_rst_tpu_torch.solvers import IPConfig
from perfbench.reference import problem, solve

CONFIG = json.loads((pathlib.Path(__file__).resolve().parents[1]
                     / "perfbench" / "configs" / "di_h50_ip.json").read_text())
# U of the float64 IP against the float64 reference: IP's KKT tolerance 1e-8
# times config 1's conditioning (about 1e3); ten times below the float32 IP's
# own gap on these lanes (5e-4 to 2e-3, tools/ip_calibration.py)
U_TOL_F64 = 1e-5


def x0s(n: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((n, 2), generator=gen, dtype=torch.float64) * 2 - 1


def test_the_sweep_entry_takes_the_ip_backend_bit_for_bit():
    ocp, cfg = entry.flagship_ip(12, device="cpu")
    assert isinstance(cfg, IPConfig)
    x0 = x0s(8, 5).float()
    got = make_batched_solver(ocp, cfg, device="cpu")(x0)
    want = make_batched_ip_solver(ocp, cfg, device="cpu")(x0)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool((got[2] == 1).all())


def test_the_ip_backend_refuses_a_mesh():
    ocp, cfg = entry.flagship_ip(12, device="cpu")
    with pytest.raises(ValueError, match="interior-point"):
        make_batched_solver(ocp, cfg, mesh=object(), device="cpu")


def test_float64_ip_agrees_with_the_benchmarks_reference():
    x0 = x0s(16, 19)
    U_ref, ok = solve.solve(problem.build(CONFIG), x0)
    assert bool(ok.all())
    ocp, cfg32 = entry.flagship_ip(50, dtype=torch.float64, device="cpu")
    U64, _, status, _ = make_batched_solver(ocp, IPConfig(), device="cpu",
                                            dtype=torch.float64)(x0)
    assert bool((status == 1).all())
    gap64 = float((U64 - U_ref).abs().max())
    assert gap64 <= U_TOL_F64, gap64
    ocp32, _ = entry.flagship_ip(50, device="cpu")
    U32, _, status32, _ = make_batched_solver(ocp32, cfg32, device="cpu")(x0.float())
    assert bool((status32 == 1).all())
    gap32 = float((U32.double() - U_ref).abs().max())
    assert gap32 > 10 * U_TOL_F64, gap32


def test_the_benchmark_configuration_states_the_ports_ip_settings():
    assert CONFIG["builder"] == "flagship_ip"
    block = dict(CONFIG["solver"])
    assert block.pop("kind") == "ip"
    assert block == entry.IP_F32_CONFIG1
    _, cfg = entry.flagship_ip(12, device="cpu")
    assert (cfg.tol, cfg.max_iter) == (block["tol"], block["max_iter"])
