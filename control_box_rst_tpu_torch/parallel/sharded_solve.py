"""Batched MPC solves and closed-loop rollouts, optionally sharded.

Counterpart of the JAX package's ``parallel/sharded_solve.py``. Each MPC
solve is independent, so the batch is simply the leading dim of every tensor
the solver touches. Under a ``mesh`` (``parallel/mesh.py``) each rank runs
the same single-device solve on its own lanes — the counterpart of the
reference's ``shard_map``, collective-free — and the results are ``Shard(0)``
DTensors over the mesh.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from control_box_rst_tpu_torch.ocp.problem import Trajectory
from control_box_rst_tpu_torch.ocp.transcribe import TranscribedOCP
from control_box_rst_tpu_torch.parallel.mesh import from_local_batch, local_batch, mesh_device
from control_box_rst_tpu_torch.sim.closed_loop import ClosedLoopResult, run_closed_loop
from control_box_rst_tpu_torch.sim.plant import SimulatedPlant
from control_box_rst_tpu_torch.sim.step_graphs import StepGraphs, graph_engages
from control_box_rst_tpu_torch.solvers.ip import IPConfig, ip_solve
from control_box_rst_tpu_torch.solvers.lm import LMConfig, lm_solve
from control_box_rst_tpu_torch.solvers.sqp import (
    SQPConfig,
    hoist_structure,
    resolve_qp_backend,
    sqp_solve,
)
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype
from control_box_rst_tpu_torch.utils.profiling import span
from control_box_rst_tpu_torch.utils.tree import tree_to


def _resolve_device(device, mesh) -> torch.device:
    """``device``, or the mesh's: a sharded solve runs where its shards live."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device {device} is not the mesh's ({mesh.device_type})")
    return mesh_device(mesh)


def make_batched_solver(
    ocp: TranscribedOCP,
    cfg: Optional[Union[SQPConfig, IPConfig]] = None,
    dt_init: float = 0.1,
    mesh=None,
    device=None,
    dtype=None,
):
    """Returns fn x0s [B, nx] → (U [B, N, nu], objective, status, iterations).

    The backend is the config's: an ``SQPConfig`` (or ``None``) solves by SQP,
    an ``IPConfig`` by the interior-point solve of ``make_batched_ip_solver``
    (one OCP, the solver plugged in).

    ``device=None`` means the card and raises when there is none; the CPU has
    to be asked for (``device="cpu"``). ``dtype=None`` means float32. The OCP
    is moved to that device/dtype once, here; x0s may be a tensor or a numpy
    array.

    With a ``mesh`` the device is the mesh's; x0s may also be a ``Shard(0)``
    DTensor (a whole batch is sharded first), each rank solves its own lanes,
    and the four results are ``Shard(0)`` DTensors over the mesh. The
    interior-point backend has no sharded path and raises under a mesh.
    """
    if isinstance(cfg, IPConfig):
        if mesh is not None:
            raise ValueError("make_batched_solver: the interior-point backend (IPConfig) "
                             "has no mesh= path")
        return span("entry.solve")(
            make_batched_ip_solver(ocp, cfg, dt_init=dt_init, device=device, dtype=dtype))
    device = _resolve_device(device, mesh)
    dtype = resolve_dtype(dtype)
    # fused QP solve: float32 box-only QP on the card — the kernel's envelope
    cfg = resolve_qp_backend(cfg or SQPConfig(), ocp.ng, device, dtype)
    ocp = ocp.to(device=device, dtype=dtype)
    N, nu = ocp.N, ocp.nu
    xf = ocp.bc.xf if ocp.bc.xf is not None else ocp.refs.xref[-1]
    # every call starts from the same U and dts, so the constant structure of
    # an LTI problem (J, K, Hd) is evaluated once, here, not once per call
    hoisted = hoist_structure(
        ocp, Trajectory.linear_interp(ocp.bc.x0, xf, N, nu, dt_init), cfg
    )

    @span("entry.solve")
    def solve(x0s):
        x0s = torch.as_tensor(x0s).to(device=device, dtype=dtype)
        o = ocp.replace(bc=ocp.bc.replace(x0=x0s))
        # X is per lane; U and dts are shared and stay unbatched, which lets
        # sqp_solve evaluate the LTI linearization once per batch
        traj0 = Trajectory.linear_interp(x0s, xf, N, nu, dt_init)
        res = sqp_solve(o, traj0, cfg, hoisted=hoisted)
        return res.traj.U, res.objective, res.status, res.iterations

    if mesh is None:
        return solve
    return lambda x0s: from_local_batch(solve(local_batch(x0s, mesh)[0]), mesh)


def _from_straight_line(ocp: TranscribedOCP, dt_init: float, device, dtype, run):
    """fn x0s [B, nx] → ``run(o, traj0)``: the OCP moved to ``device`` /
    ``dtype`` once, here; each call sets x0 per lane and starts from the
    straight line to the target (``make_batched_lm_solver``,
    ``make_batched_ip_solver``)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    ocp = ocp.to(device=device, dtype=dtype)
    N, nu = ocp.N, ocp.nu
    xf = ocp.bc.xf if ocp.bc.xf is not None else ocp.refs.xref[-1]

    def solve(x0s):
        x0s = torch.as_tensor(x0s).to(device=device, dtype=dtype)
        o = ocp.replace(bc=ocp.bc.replace(x0=x0s))
        return run(o, Trajectory.linear_interp(x0s, xf, N, nu, dt_init))

    return solve


def make_batched_lm_solver(
    ocp: TranscribedOCP,
    cfg: Optional[LMConfig] = None,
    dt_init: float = 0.1,
    device=None,
    dtype=None,
    inplace: bool = True,
):
    """Returns fn x0s [B, nx] → (U [B, N, nu], chi2, status, iterations,
    feas_res): the batched Levenberg-Marquardt solve from the straight-line
    initial guess, every lane with its own μ, penalty weights and iteration
    count. ``device`` and ``dtype`` as in ``make_batched_solver``. ``inplace``
    selects which of the two block-tridiagonal kernels solves the linear
    system of an iteration on the card (``ops/cuda/btridiag_kernel.py``);
    the answer does not depend on it."""
    cfg = cfg or LMConfig()

    def run(o, traj0):
        res = lm_solve(o, traj0, cfg, inplace=inplace)
        return res.traj.U, res.chi2, res.status, res.iterations, res.feas_res

    return _from_straight_line(ocp, dt_init, device, dtype, run)


def make_batched_ip_solver(
    ocp: TranscribedOCP,
    cfg: Optional[IPConfig] = None,
    dt_init: float = 0.1,
    device=None,
    dtype=None,
    inplace: bool = True,
):
    """Returns fn x0s [B, nx] → (U [B, N, nu], objective, status, iterations):
    the batched interior-point solve from the straight-line initial guess,
    every lane with its own barrier parameter and iteration count (the
    counterpart of the reference's ``jax.vmap(ip_solve)``). ``device`` and
    ``dtype`` as in ``make_batched_solver``; ``inplace`` as in
    ``make_batched_lm_solver`` (which block-tridiagonal kernel solves the
    Schur system of an iteration on the card)."""
    cfg = cfg or IPConfig()

    def run(o, traj0):
        res = ip_solve(o, traj0, cfg, inplace=inplace)
        return res.traj.U, res.objective, res.status, res.iterations

    return _from_straight_line(ocp, dt_init, device, dtype, run)


def make_batched_closed_loop(
    controller,
    plant: SimulatedPlant,
    T_steps: int,
    dt: float,
    mesh=None,
    device=None,
    dtype=None,
    observer=None,
):
    """Returns fn(x0s [B, nx], generator=None) → ``ClosedLoopResult`` of B
    closed-loop rollouts of T_steps each (results [B, T(+1), …]).

    ``controller``: a ``PredictiveController``, a ``DualModeController``
    over one, or any controller with a ``to``. It is rebuilt for ``device``
    / ``dtype`` (``None``: the card, raising when there is none; float32)
    once, here: a predictive controller's OCP is moved there and its
    constant structure hoisted, and ``cfg.qp.backend=None`` resolves to the
    fused box-QP kernel for a float32 solve on the card. ``observer``
    (``None``: the state is measured) is moved there too. x0s may be a
    tensor or a numpy array; ``generator`` is what noisy plants draw from
    (on ``device``; ``None`` means one seeded with 0). Where
    ``sim.step_graphs.graph_engages`` says so (config 5's one-shot SQP
    controller on the card, the state measured, a noise-free plant), a call
    replays the MPC step from two CUDA graphs, captured by the first call
    and again by each call whose batch size differs from the one before
    (the old graphs are dropped): the result is the eager loop's bit for bit.

    With a ``mesh`` the device is the mesh's; x0s may also be a ``Shard(0)``
    DTensor, each rank rolls out its own lanes, and every field of the
    result is a ``Shard(0)`` DTensor over the mesh. Every rank draws the
    noise of the whole batch from its generator (the same seed on every
    rank) and keeps its own lanes, so a lane's rollout, noise included, is
    the one it has in the unsharded batch."""
    device = _resolve_device(device, mesh)
    dtype = resolve_dtype(dtype)
    controller = controller.to(device, dtype)
    plant = tree_to(plant, device, dtype)
    observer = None if observer is None else tree_to(observer, device, dtype)
    graphed = graph_engages(controller, plant, observer, device)
    graphs = None

    @span("entry.rollout")
    def run(x0s, generator, plant) -> ClosedLoopResult:
        nonlocal graphs
        x0s = torch.as_tensor(x0s).to(device=device, dtype=dtype)
        if graphed and x0s.dim() == 2:
            if graphs is None or graphs.B != x0s.shape[0]:
                graphs = None
                graphs = StepGraphs(controller, plant, x0s.shape[0], dt)
            return graphs.run(x0s, T_steps)
        return run_closed_loop(plant, controller, x0s, T_steps, dt, observer=observer,
                               generator=generator)

    if mesh is None:
        return lambda x0s, generator=None: run(x0s, generator, plant)

    def sharded(x0s, generator=None) -> ClosedLoopResult:
        local, offset, total = local_batch(x0s, mesh)
        return from_local_batch(
            run(local, generator, plant.with_lane_window(offset, total)), mesh)

    return sharded
