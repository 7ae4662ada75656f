"""The port's threaded plant and real-time loop
(``sim/plant_threaded.py``, ``sim/realtime.py``) on the CPU, float64.

- The three threaded-plant cases of
  ``tests/test_preprocessor_and_threaded_plant.py:77-135``, with the
  reference's bounds: the free response of the double integrator, the
  actuation dead time and ``set_state``, the real-time executor closing the
  loop on the threaded plant with an LQR.
- Cancellation: an ``on_step`` that clears ``core.console.ok()`` at step 4
  stops the loop after 5 steps; after ``set_ok(True)`` the next run goes
  whole. A finalizer sets the flag again whatever happens, because the flag
  is process-global and the next test file in this worker may run a loop.
"""
import time

import numpy as np
import pytest
import torch

from control_box_rst_tpu_torch.control import LqrController
from control_box_rst_tpu_torch.core.console import ok, set_ok
from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
from control_box_rst_tpu_torch.sim import SimulatedPlant, SimulatedPlantThreaded
from control_box_rst_tpu_torch.sim.realtime import run_realtime_closed_loop

F64 = dict(device="cpu", dtype=torch.float64)

torch.set_num_threads(1)


def _lqr():
    return LqrController.from_system(
        DoubleIntegratorContinuous(), Q=torch.eye(2, **F64), R=torch.eye(1, **F64),
        xref=torch.zeros(2, **F64), **F64)


def test_threaded_plant_free_response_matches_direct_integration():
    """Run the plant thread with u=0; the double integrator with x0=[0,1]
    drifts x0(t) = t."""
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    th = SimulatedPlantThreaded(plant, x0=np.array([0.0, 1.0]), sim_dt=0.005, **F64)
    with th:
        time.sleep(0.5)
        y = th.read_output()
    # position grew ≈ elapsed sim time * velocity 1 (rate-synced ≈ wall
    # clock, minus the thread's start-up)
    assert y.shape == (2,)
    assert 0.05 < y[0] < 0.8, y
    assert np.isclose(y[1], 1.0, atol=1e-6)  # velocity untouched (u=0)


def test_threaded_plant_control_and_deadtime():
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    th = SimulatedPlantThreaded(plant, x0=np.zeros(2), sim_dt=0.005, dead_time=0.1, **F64)
    with th:
        th.write_control(np.array([1.0]))
        time.sleep(0.05)
        v_early = th.state()[1]  # dead time not elapsed → still coasting
        time.sleep(0.3)
        v_late = th.state()[1]
    assert abs(v_early) < 0.02, v_early
    assert v_late > 0.1, v_late  # control applied after dead time
    th.set_state(np.array([5.0, 0.0]))
    assert th.state()[0] == 5.0


def test_threaded_plant_with_realtime_executor():
    """Close the loop: the real-time executor drives the threaded plant
    through its callback API."""
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    th = SimulatedPlantThreaded(plant, x0=np.array([0.5, 0.0]), sim_dt=0.004, **F64)
    with th:
        stats = run_realtime_closed_loop(
            _lqr(),
            read_output=th.read_output,
            write_control=th.write_control,
            x0=np.array([0.5, 0.0]),
            dt=0.02,
            duration_s=1.2,
            **F64,
        )
        x_final = th.state()
    assert stats["steps"] == 60
    # LQR regulates toward the origin despite the async plant
    assert abs(x_final[0]) < 0.4, x_final


@pytest.fixture
def ok_restored():
    yield
    set_ok(True)


def test_cancellation_stops_the_loop_between_steps(ok_restored):
    state = {"x": np.array([1.0, 0.0])}
    read = lambda: state["x"]
    write = lambda u: None
    seen = []

    def on_step(k, x_hat, u):
        seen.append(k)
        if k == 4:
            set_ok(False)

    assert ok()
    stats = run_realtime_closed_loop(_lqr(), read, write, x0=state["x"], dt=0.01,
                                     duration_s=0.2, on_step=on_step, **F64)
    assert stats["steps"] == 5 and seen == [0, 1, 2, 3, 4]
    assert not ok()
    set_ok(True)
    stats = run_realtime_closed_loop(_lqr(), read, write, x0=state["x"], dt=0.01,
                                     duration_s=0.2, **F64)
    assert stats["steps"] == 20
