"""Profiling and phase-timing utilities.

Counterpart of the JAX package's ``utils/profiling.py``: a host-side phase
timer whose results slot into the signal recorder, and a device trace.
``PhaseTimer.phase(..., block_on=...)`` waits for the device that holds the
tensors in ``block_on`` before it stops the clock (the reference's
``jax.block_until_ready``); ``device_trace`` runs ``torch.profiler`` over the
CPU and, where there is a card, CUDA activities and writes a Chrome trace
(the reference's ``jax.profiler`` trace).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


def _synchronize(block_on) -> None:
    """Wait for every CUDA device that holds a tensor of ``block_on`` (a
    tensor or a nest of lists, tuples and dicts of them); a CPU tensor has
    nothing to wait for."""
    if isinstance(block_on, torch.Tensor):
        if block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
    elif isinstance(block_on, dict):
        for v in block_on.values():
            _synchronize(v)
    elif isinstance(block_on, (list, tuple)):
        for v in block_on:
            _synchronize(v)


class PhaseTimer:
    """Accumulate wall-clock per named phase (waits for device results)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1),
            }
            for k in self.totals
        }


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the block; yields the profiler (its
    ``key_averages()`` / ``events()`` are there after the block) and, when
    the block ends without raising, writes ``logdir/trace_<pid>_<n>.json``, a
    Chrome trace (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))
