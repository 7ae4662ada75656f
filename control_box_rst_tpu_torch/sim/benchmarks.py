"""Benchmark tasks.

Counterpart of the JAX package's ``sim/benchmarks.py``:
``benchmark_varying_initial_state`` sweeps a 2-D grid of initial states
(x01 × x02) of a closed-loop task. The reference library reruns the task per
initial state; here the whole sweep is ONE batch of rollouts
(``parallel.make_batched_closed_loop``). The increasing-N open-loop sweeps
need masked horizons and come with the grid-adaptation slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from control_box_rst_tpu_torch.sim.plant import SimulatedPlant
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
    ``device=None`` means the card, ``dtype=None`` float32."""
    from control_box_rst_tpu_torch.parallel.sharded_solve import make_batched_closed_loop

    device, dtype = resolve_device(device), resolve_dtype(dtype)
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
    return roll(x0s, generator), x0s
