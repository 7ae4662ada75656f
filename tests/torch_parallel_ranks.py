"""Rank bodies of tests/test_torch_parallel.py: what each spawned gloo rank
runs on the CPU. This module imports the port only (no JAX), so that every
spawned rank starts with torch and the port alone."""
import time

import numpy as np
import torch

from control_box_rst_tpu_torch.control import PredictiveController
from control_box_rst_tpu_torch.entry import dryrun_multichip, flagship
from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
from control_box_rst_tpu_torch.parallel import (
    batch_sharding,
    make_batched_closed_loop,
    make_batched_solver,
    make_mesh,
    shard_batch,
)
from control_box_rst_tpu_torch.parallel.mesh import gather_batch
from control_box_rst_tpu_torch.sim import GaussianNoise, SimulatedPlant
from control_box_rst_tpu_torch.sim.benchmarks import benchmark_varying_initial_state
from control_box_rst_tpu_torch.solvers import QPConfig, SQPConfig

F64 = dict(device="cpu", dtype=torch.float64)
# the reference's tests/test_parallel.py: config 1 at N=20, B=16
SOLVE_N, SOLVE_B = 20, 16
SOLVE_CFG = dict(max_iter=6, qp=dict(max_iter=200, tol=1e-10))
# the closed loop: config 1's OCP at N=10 under MPC (tests/test_torch_closed_loop_runs.py)
LOOP_N, LOOP_T, LOOP_DT, LOOP_B = 10, 3, 0.1, 8
LOOP_CFG = dict(max_iter=10, qp=dict(max_iter=200, tol=1e-10))
NOISE_STD, NOISE_SEED = 0.01, 5
SWEEP_X01, SWEEP_X02 = np.linspace(-1.0, 1.0, 4), np.linspace(-0.5, 0.5, 2)


def sqp_cfg(settings):
    return SQPConfig(qp=QPConfig(**settings["qp"]),
                     **{k: v for k, v in settings.items() if k != "qp"})


def solve_x0s():
    return np.random.default_rng(0).uniform(-1.0, 1.0, size=(SOLVE_B, 2))


def loop_x0s():
    return np.random.default_rng(1).uniform(-1.0, 1.0, size=(LOOP_B, 2))


def controller():
    ocp, _ = flagship(N=LOOP_N, **F64)
    return PredictiveController(nx=2, nu=1, ocp=ocp, dt=LOOP_DT, cfg=sqp_cfg(LOOP_CFG), **F64)


def plant(noisy: bool):
    """The double integrator; with input, state and output noise when noisy."""
    if not noisy:
        return SimulatedPlant(system=DoubleIntegratorContinuous())
    n = GaussianNoise(std=NOISE_STD)
    return SimulatedPlant(system=DoubleIntegratorContinuous(), input_noise=n, state_noise=n,
                          output_noise=n)


def generator():
    g = torch.Generator()
    g.manual_seed(NOISE_SEED)
    return g


def closed_loop_fields(res):
    """A ClosedLoopResult as a flat dict of numpy arrays."""
    out = {f: res._asdict()[f].numpy() for f in ("ts", "x_true", "y", "x_observed", "u", "ok")}
    out.update({f"info.{k}": v.numpy() for k, v in res.info.items()})
    return out


def unsharded():
    """The same work without a mesh (the parent's reference)."""
    ocp, _ = flagship(N=SOLVE_N, **F64)
    solve = make_batched_solver(ocp, sqp_cfg(SOLVE_CFG), dt_init=0.1, **F64)
    roll = make_batched_closed_loop(controller(), plant(True), LOOP_T, LOOP_DT, **F64)
    sweep, _ = benchmark_varying_initial_state(
        plant(True), controller(), SWEEP_X01, SWEEP_X02, LOOP_T, LOOP_DT, generator=generator(),
        **F64)
    return dict(solve=[o.numpy() for o in solve(solve_x0s())],
                closed_loop=closed_loop_fields(roll(loop_x0s(), generator())),
                sweep=closed_loop_fields(sweep))


def _raises_value_error(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def body(rank):
    """Every sharded case on this rank; gathered results and this rank's
    shard sizes come back."""
    mesh = make_mesh(device_type="cpu")
    world = mesh.size()
    ocp, _ = flagship(N=SOLVE_N, **F64)
    solve = make_batched_solver(ocp, sqp_cfg(SOLVE_CFG), dt_init=0.1, mesh=mesh, **F64)
    outs = solve(shard_batch(solve_x0s(), mesh))
    # the reference's test_sharded_solution_is_partitioned: N=10, 8 lanes
    ocp10, _ = flagship(N=10, **F64)
    part = make_batched_solver(ocp10, SQPConfig(max_iter=4), dt_init=0.1, mesh=mesh, **F64)(
        shard_batch(np.ones((8, 2)) * 0.5, mesh))
    roll = make_batched_closed_loop(controller(), plant(True), LOOP_T, LOOP_DT, mesh=mesh, **F64)
    loop = roll(loop_x0s(), generator())
    sweeps = {}
    for noisy in (True, False):
        res, x0s = benchmark_varying_initial_state(
            plant(noisy), controller(), SWEEP_X01, SWEEP_X02, LOOP_T, LOOP_DT, mesh=mesh,
            generator=generator(), **F64)
        sweeps[noisy] = (res, x0s)
    dryrun_multichip(world, device_type="cpu")
    return dict(
        world=world,
        placements=[tuple(o.placements) == batch_sharding(mesh) for o in (*outs, *part, *loop[:-1])],
        local_lanes=dict(solve=[o.to_local().shape[0] for o in outs],
                         partitioned=[o.to_local().shape[0] for o in part],
                         closed_loop=loop.u.to_local().shape[0]),
        solve=[o.numpy() for o in gather_batch(outs)],
        full_tensor_equal=bool(torch.equal(outs[0].full_tensor(), gather_batch(outs[0]))),
        closed_loop=closed_loop_fields(gather_batch(loop)),
        sweep=closed_loop_fields(gather_batch(sweeps[True][0])),
        sweep_noise_free=closed_loop_fields(gather_batch(sweeps[False][0])),
        sweep_x0s=gather_batch(sweeps[True][1]).numpy(),
        uneven_raises=[
            _raises_value_error(lambda: shard_batch(np.zeros((SOLVE_B + 1, 2)), mesh)),
            _raises_value_error(lambda: solve(np.zeros((world + 1, 2)))),
            _raises_value_error(lambda: roll(np.zeros((world + 1, 2)))),
        ],
    )


def hang(rank):
    time.sleep(600)


def fail(rank):
    raise RuntimeError(f"rank {rank} fails")
