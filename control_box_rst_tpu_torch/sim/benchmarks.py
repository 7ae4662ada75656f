"""Benchmark tasks.

Counterpart of the JAX package's ``sim/benchmarks.py``:
``benchmark_varying_initial_state`` sweeps a 2-D grid of initial states
(x01 × x02) of a closed-loop task. The reference library reruns the task per
initial state; here the whole sweep is ONE batch of rollouts
(``parallel.make_batched_closed_loop``). ``benchmark_increasing_n_open_loop``
solves one open-loop problem per horizon length N, each built at its N;
``benchmark_increasing_n_masked`` solves the same sweep as ONE batch at the
longest horizon, each lane with its own active horizon (a per-lane stage
mask: inactive tail intervals become identity chains).

Timings are wall-clock seconds of a solve on the device the caller names,
after one untimed solve of the same problem, the device synchronized around
the timed one.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from control_box_rst_tpu_torch.ocp.adaptation import stage_mask_from_n
from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.sim.plant import SimulatedPlant
from control_box_rst_tpu_torch.solvers.sqp import SQPConfig, resolve_qp_backend, sqp_solve
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype


def benchmark_varying_initial_state(
    plant: SimulatedPlant,
    controller,
    x01_values,
    x02_values,
    T_steps: int,
    dt: float,
    x0_template: Optional[torch.Tensor] = None,
    mesh=None,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype=None,
):
    """Closed-loop rollouts over the grid x01 × x02 (the first two state
    dims; the others from ``x0_template``, zeros by default). Returns the
    ``ClosedLoopResult`` of the batch, lanes in x01-major order
    (len(x01)·len(x02) of them), and the initial states [B, nx].
    ``device=None`` means the card, ``dtype=None`` float32. With a ``mesh``
    every rank builds the whole grid on the mesh's device and rolls out its
    own lanes: the result and the initial states are ``Shard(0)`` DTensors
    (``parallel.make_batched_closed_loop``)."""
    from control_box_rst_tpu_torch.parallel.mesh import mesh_device, shard_batch
    from control_box_rst_tpu_torch.parallel.sharded_solve import make_batched_closed_loop

    device = resolve_device(device) if mesh is None else mesh_device(mesh)
    dtype = resolve_dtype(dtype)
    kw = dict(dtype=dtype, device=device)
    nx = plant.system.nx
    g1, g2 = torch.meshgrid(
        torch.as_tensor(x01_values, **kw), torch.as_tensor(x02_values, **kw), indexing="ij")
    if x0_template is None:
        x0_template = torch.zeros((nx,), **kw)
    x0s = torch.as_tensor(x0_template, **kw).expand(g1.numel(), nx).clone()
    x0s[:, 0] = g1.reshape(-1)
    x0s[:, 1] = g2.reshape(-1)
    roll = make_batched_closed_loop(
        controller, plant, T_steps, dt, mesh=mesh, device=device, dtype=dtype)
    if mesh is not None:
        x0s = shard_batch(x0s, mesh)
    return roll(x0s, generator), x0s


def _timed_solve(ocp, traj0, cfg, device):
    """(result, seconds) of the second of two identical solves."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sqp_solve(ocp, traj0, cfg)
    sync()
    t0 = time.perf_counter()
    res = sqp_solve(ocp, traj0, cfg)
    sync()
    return res, time.perf_counter() - t0


def _goal(ocp) -> torch.Tensor:
    return ocp.bc.xf if ocp.bc.xf is not None else ocp.refs.xref[-1]


def benchmark_increasing_n_open_loop(
    make_ocp,
    N_values: Sequence[int],
    x0,
    dt_init: float,
    cfg: Optional[SQPConfig] = None,
    device=None,
    dtype=None,
):
    """One open-loop SQP solve per horizon length N, from the straight line
    x0 → goal with dt = ``dt_init``; ``make_ocp(N)`` builds the OCP of
    horizon N (its own ``bc.x0`` is the initial state). Returns one dict per
    N: N, objective, iterations, feas_res, status, solve_time_s.
    ``device=None`` means the card, ``dtype=None`` float32; ``cfg.qp.backend
    =None`` resolves to the fused box-QP kernel for float32 on the card."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    cfg = cfg or SQPConfig()
    x0 = torch.as_tensor(x0).to(device=device, dtype=dtype)
    results = []
    for N in N_values:
        ocp = make_ocp(int(N)).to(device=device, dtype=dtype)
        traj0 = Trajectory.linear_interp(x0, _goal(ocp), int(N), ocp.nu, dt_init)
        res, wall = _timed_solve(
            ocp, traj0, resolve_qp_backend(cfg, ocp.ng, device, dtype), device)
        results.append(dict(
            N=int(N), objective=float(res.objective), iterations=int(res.iterations),
            feas_res=float(res.feas_res), status=int(res.status), solve_time_s=wall,
        ))
    return results


def benchmark_increasing_n_masked(
    ocp_max,
    N_values: Sequence[int],
    x0,
    dt_init: float,
    cfg: Optional[SQPConfig] = None,
    device=None,
    dtype=None,
):
    """The sweep of ``benchmark_increasing_n_open_loop`` as ONE batched solve
    of ``ocp_max`` (horizon N_max): lane i has the active horizon
    ``N_values[i]`` through a per-lane stage mask, every lane from the same
    straight line over N_max intervals. Returns one dict per lane: N,
    objective, iterations, feas_res, and solve_time_s (the whole batch).
    ``device``, ``dtype`` and the backend as in the open-loop sweep."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    ocp = ocp_max.to(device=device, dtype=dtype)
    cfg = resolve_qp_backend(cfg or SQPConfig(), ocp.ng, device, dtype)
    ns = torch.as_tensor(list(N_values), device=device)
    ocp = ocp.replace(stage_mask=stage_mask_from_n(ns, ocp.N, dtype, device))
    x0 = torch.as_tensor(x0).to(device=device, dtype=dtype)
    traj0 = Trajectory.linear_interp(x0, _goal(ocp), ocp.N, ocp.nu, dt_init)
    res, wall = _timed_solve(ocp, traj0, cfg, device)
    return [
        dict(N=int(n), objective=float(o), iterations=int(i), feas_res=float(f),
             solve_time_s=wall)
        for n, o, i, f in zip(ns.tolist(), res.objective.tolist(),
                              res.iterations.tolist(), res.feas_res.tolist())
    ]
