"""The port's native runtime (``control_box_rst_tpu_torch.native``): the
six cases of ``tests/test_native_runtime.py`` with the reference's own
timing bounds, on the CPU.

The library is compiled with g++ from the port's copy of ``runtime.cpp``
into ``build/native/`` at first use. The real-time case drives an LQR of
each package (float64) through its package's ``run_realtime_closed_loop``
against the same synchronous plant (the JAX package's RK4 step, applied in
``write_control``), and the two ``SignalWriter`` logs of (x̂, u) agree
within 1e-9.
"""
import os
import time

import jax.numpy as jnp
import numpy as np
import torch

from control_box_rst_tpu_torch.native import (
    Rate,
    SignalWriter,
    monotonic_time,
    native_available,
    read_signal_log,
    set_realtime_priority,
)

F64 = dict(device="cpu", dtype=torch.float64)


def test_native_library_builds():
    from control_box_rst_tpu_torch import native

    assert native_available(), "g++ build of runtime.cpp failed"
    assert native._LIB.is_file() and native._LIB.parent.name == "native"
    assert native._LIB.parent.parent.name == "build"


def test_rate_timing():
    rate = Rate(0.02)
    t0 = monotonic_time()
    for _ in range(10):
        rate.sleep()
    elapsed = monotonic_time() - t0
    # 10 periods of 20ms: allow generous jitter on shared CI machines
    assert 0.18 <= elapsed < 0.5, elapsed
    assert rate.overruns == 0


def test_rate_overrun_detection():
    rate = Rate(0.005)
    time.sleep(0.05)  # blow through several deadlines
    slack = rate.sleep()
    assert slack < 0
    assert rate.overruns >= 1


def test_signal_writer_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "log.bin")
    w = SignalWriter(path, dim=3, capacity=1024)
    for k in range(100):
        assert w.push(k * 0.01, np.array([k, 2.0 * k, -k]))
    w.close()
    ts, vals = read_signal_log(path)
    assert ts.shape == (100,) and vals.shape == (100, 3)
    np.testing.assert_allclose(ts, np.arange(100) * 0.01)
    np.testing.assert_allclose(vals[:, 1], 2.0 * np.arange(100))
    assert w.dropped == 0


def test_set_realtime_priority_no_crash():
    # usually fails without CAP_SYS_NICE — must not raise either way
    set_realtime_priority(5)


def _run(run_realtime_closed_loop, ctrl, log, **kw):
    """One 0.5 s real-time run at dt 0.02 from [1, 0] against the JAX
    package's RK4 plant, stepped once per written control."""
    from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
    from control_box_rst_tpu.ops.integrators import make_integrator

    sys_, integ = JaxDI(), make_integrator("rk4", 2)
    state = {"x": np.array([1.0, 0.0])}

    def read_output():
        return state["x"]

    def write_control(u):
        state["x"] = np.asarray(
            integ.solve_ivp(sys_, jnp.asarray(state["x"]), jnp.asarray(u), 0.02)
        )

    stats = run_realtime_closed_loop(
        ctrl, read_output, write_control,
        x0=np.array([1.0, 0.0]), dt=0.02, duration_s=0.5, log_path=log, **kw,
    )
    return stats, state["x"]


def test_realtime_closed_loop_sim(tmp_path):
    """Drive the real-time executor against an in-process simulated plant;
    the JAX package's executor with its own LQR logs the same (x̂, u)."""
    from control_box_rst_tpu.control import LqrController as JaxLqr
    from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
    from control_box_rst_tpu.sim.realtime import run_realtime_closed_loop as jax_run

    from control_box_rst_tpu_torch.control import LqrController
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.sim.realtime import run_realtime_closed_loop

    ctrl = LqrController.from_system(DoubleIntegratorContinuous(), torch.eye(2, **F64),
                                     torch.eye(1, **F64), **F64)
    log = os.path.join(tmp_path, "rt.bin")
    stats, x = _run(run_realtime_closed_loop, ctrl, log, **F64)
    assert stats["steps"] == 25
    assert np.linalg.norm(x) < 1.0  # heading toward origin
    ts, vals = read_signal_log(log)
    assert vals.shape == (25, 3)
    assert stats["solve_time_p99_s"] < 0.02 or stats["overruns"] >= 0
    assert stats["log_dropped"] == 0

    jax_log = os.path.join(tmp_path, "rt_jax.bin")
    jax_stats, jax_x = _run(jax_run, JaxLqr.from_system(JaxDI(), jnp.eye(2), jnp.eye(1)), jax_log)
    assert jax_stats["steps"] == 25
    jts, jvals = read_signal_log(jax_log)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(vals, jvals, rtol=0, atol=1e-9)
    np.testing.assert_allclose(x, jax_x, rtol=0, atol=1e-9)
