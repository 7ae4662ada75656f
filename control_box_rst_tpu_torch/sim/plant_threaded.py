"""Threaded simulated plant: fixed-rate simulation in its own host thread.

Counterpart of the JAX package's ``sim/plant_threaded.py`` (the reference's
SimulatedPlantThreaded): the plant's integration loop runs in a dedicated
thread at the simulation rate, with the commanded control held in a
lock-guarded buffer, so the controller and the plant evolve asynchronously,
as with hardware: the plant does not wait for the solver.

For simulation studies the plant is stepped inside the batched closed loop
(``sim/closed_loop.py``). This class is for the real-time path: it steps a
``SimulatedPlant`` every ``sim_dt`` seconds, paced by the native drift-free
``Rate``, and exposes ``read_output()`` / ``write_control()``, the callbacks
``sim.realtime.run_realtime_closed_loop`` drives. A control is applied after
an optional actuation dead time.

State and control live on the host as float64 numpy; each step and output
runs on ``device`` (``None`` means the card and raises without one) as
``dtype`` (``None``: float32) on a batch of one. Noise is drawn from a
``torch.Generator`` on ``device`` seeded with ``seed`` (so its stream is not
the reference's ``jax.random`` stream).
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from control_box_rst_tpu_torch.sim.plant import SimulatedPlant
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype


class SimulatedPlantThreaded:
    """Host-side asynchronous plant simulation at a fixed rate."""

    def __init__(
        self,
        plant: SimulatedPlant,
        x0: np.ndarray,
        sim_dt: float = 0.001,
        dead_time: float = 0.0,
        seed: int = 0,
        device=None,
        dtype=None,
    ):
        self._plant = plant
        self._device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self._sim_dt = float(sim_dt)
        self._dead_time = float(dead_time)
        self._lock = threading.Lock()
        self._x = np.asarray(x0, dtype=np.float64)
        self._u = np.zeros((plant.system.nu,), dtype=np.float64)
        # pending (apply_time, u) commands when dead_time > 0
        self._u_queue: list = []
        self._t = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the plant thread's Rate, once started (its ``overruns``: periods
        # the simulation could not keep)
        self.rate = None
        self._generator = torch.Generator(device=self._device).manual_seed(int(seed))
        # one generator for the plant thread and the reader: draws take turns
        self._gen_lock = threading.Lock()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self._dtype, device=self._device)[None]

    def _step(self, x: np.ndarray, u: np.ndarray, generator) -> np.ndarray:
        x_next = self._plant.step(self._tensor(x), self._tensor(u), self._sim_dt, generator)
        return x_next[0].to(torch.float64).cpu().numpy()

    def _output(self, x: np.ndarray, generator) -> np.ndarray:
        y = self._plant.output(self._tensor(x), generator)
        return y[0].to(torch.float64).cpu().numpy()

    # -- controller-facing API (matches sim/realtime.py callbacks) ---------
    def read_output(self) -> np.ndarray:
        with self._lock:
            x = self._x.copy()
        with self._gen_lock:
            return self._output(x, self._generator)

    def write_control(self, u: np.ndarray) -> None:
        """Command a control; applied after ``dead_time``."""
        with self._lock:
            if self._dead_time <= 0.0:
                self._u = np.asarray(u, dtype=np.float64).copy()
            else:
                self._u_queue.append(
                    (self._t + self._dead_time, np.asarray(u, dtype=np.float64))
                )

    def state(self) -> np.ndarray:
        with self._lock:
            return self._x.copy()

    def set_state(self, x: np.ndarray) -> None:
        with self._lock:
            self._x = np.asarray(x, dtype=np.float64).copy()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SimulatedPlantThreaded":
        if self._thread is not None:
            raise RuntimeError("plant thread already started")
        # one step and one output BEFORE the rate-synced loop starts, on a
        # generator of their own, so that the first periods of the loop do
        # not pay for first-call set-up
        warm = torch.Generator(device=self._device).manual_seed(0)
        self._step(self._x, self._u, warm)
        self._output(self._x, warm)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- simulation thread ------------------------------------------------------
    def _run(self) -> None:
        from control_box_rst_tpu_torch.native import Rate

        rate = self.rate = Rate(self._sim_dt)
        rate.reset()
        while not self._stop.is_set():
            with self._lock:
                # release dead-timed commands whose apply time has come
                while self._u_queue and self._u_queue[0][0] <= self._t:
                    self._u = self._u_queue.pop(0)[1]
                x, u = self._x, self._u
            with self._gen_lock:
                x_next = self._step(x, u, self._generator)
            with self._lock:
                self._x = x_next
                self._t += self._sim_dt
            rate.sleep()
