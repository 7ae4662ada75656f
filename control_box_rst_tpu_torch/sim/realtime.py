"""Wall-clock real-time closed-loop executor.

Counterpart of the JAX package's ``sim/realtime.py`` (the reference's
ClosedLoopControlTask in real-time mode): a ``Rate``-synchronized host loop
with optional one-step prediction that compensates the solve's own latency.

Use this when driving an external or physical plant through Python
callbacks (``sim.plant_threaded.SimulatedPlantThreaded`` is one); for
simulation studies use ``sim/closed_loop.py``, which steps a whole batch on
the device. The loop body is {read output → observe → (optionally predict)
→ solve → write control → rate.sleep()} with the native ``Rate`` for
drift-free timing and the native ``SignalWriter`` for logging.

The port's controllers are batch-first: the loop carries a batch of one
(``x[None]``) on ``device`` (``None`` means the card and raises without
one) as ``dtype`` (``None``: float32), and hands the plant ``u[0]`` as
float64 numpy. The solve time of a step runs from the controller call to
the control on the host, so it includes the copy that waits for the card.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from control_box_rst_tpu_torch.models.filters import OneStepPredictor
from control_box_rst_tpu_torch.native import Rate, SignalWriter, monotonic_time
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype


def run_realtime_closed_loop(
    controller,
    read_output: Callable[[], np.ndarray],
    write_control: Callable[[np.ndarray], None],
    x0: np.ndarray,
    dt: float,
    duration_s: float,
    observer=None,
    predictor: Optional[OneStepPredictor] = None,
    log_path: Optional[str] = None,
    on_step: Optional[Callable] = None,
    device=None,
    dtype=None,
):
    """Drive a plant at rate 1/dt. Returns run statistics.

    read_output() → current measurement y; write_control(u) applies u.
    If ``predictor`` is given, the measured state is propagated by one
    control interval before solving. The loop stops early, between steps,
    when ``core.console.ok()`` turns false.
    """
    from control_box_rst_tpu_torch.core.console import ok
    from control_box_rst_tpu_torch.sim.observer import NoObserver

    device, dtype = resolve_device(device), resolve_dtype(dtype)

    def batch(a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype, device=device)[None]

    def host(a: torch.Tensor) -> np.ndarray:
        return a[0].to(torch.float64).cpu().numpy()

    observer = observer or NoObserver()
    x0 = batch(x0)

    ctrl_carry = controller.init_carry(x0)
    obs_carry = observer.init_carry(x0)

    def ctrl_step(carry, x, t):
        return controller.step(carry, x, t, dt)

    def obs_step(carry, y, u):
        return observer.observe(carry, y, u, dt)

    # one step of each before the loop (first-call set-up: kernel builds,
    # allocations), their carries thrown away
    host(ctrl_step(ctrl_carry, x0, 0.0)[1].u)
    obs_step(obs_carry, batch(read_output()), torch.zeros((1, controller.nu), dtype=dtype,
                                                          device=device))

    writer = None
    if log_path is not None:
        writer = SignalWriter(log_path, dim=int(x0.shape[-1]) + controller.nu)

    rate = Rate(dt)
    n_steps = int(round(duration_s / dt))
    u_prev = torch.zeros((1, controller.nu), dtype=dtype, device=device)
    solve_times = []
    t_start = monotonic_time()
    rate.reset()
    for k in range(n_steps):
        if not ok():  # cooperative cancellation
            n_steps = k
            break
        t = k * dt
        y = batch(read_output())
        obs_carry, x_hat = obs_step(obs_carry, y, u_prev)
        if predictor is not None:
            x_hat = predictor.predict_single(x_hat, u_prev, dt)
        t0 = monotonic_time()
        ctrl_carry, out = ctrl_step(ctrl_carry, x_hat, t)
        u = host(out.u)
        solve_times.append(monotonic_time() - t0)
        write_control(u)
        u_prev = batch(u)
        x_hat = host(x_hat)
        if writer is not None:
            writer.push(t, np.concatenate([x_hat, u]))
        if on_step is not None:
            on_step(k, x_hat, u)
        rate.sleep()
    wall = monotonic_time() - t_start
    if writer is not None:
        writer.close()
    st = np.asarray(solve_times)
    return {
        "steps": n_steps,
        "wall_s": wall,
        "overruns": rate.overruns,
        "solve_time_mean_s": float(st.mean()),
        "solve_time_p99_s": float(np.percentile(st, 99)),
        "log_dropped": writer.dropped if writer else 0,
    }
