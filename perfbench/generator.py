"""The one traffic generator: initial states from ``--seed`` and the closed
loop that drives the window, for every mix under ``traffic/``.

A mix's parameters:

    kind            sweep | rollouts               (``system.py``)
    batch           lanes a unit (a solve batch, a rollout batch)
    steps           closed-loop steps a unit (rollouts)
    x0_low/x0_high  the box the initial states are drawn from
    strata          [a, b]: the box cut into a x b cells; every a*b draws
                    visit each cell once, in an order and at a place inside
                    the cell drawn from the seed, so that every seed draws
                    the same spread of hard and easy states
    warmup_units    units run before the window (their own draws)
    trace_units     units of the window traced with --trace 1
    check_per_unit  lanes of each unit the check compares, drawn from the seed

One caller waits for each unit: the loop is closed. The window runs units
back to back until the first one that ends ``seconds`` after the window
opened; every unit it ran counts, and the window is as long as they took.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List

import torch

from perfbench import tracing

SEED_MASK = (1 << 63) - 1


class InitialStates:
    """Stratified initial states from one seed (see the module docstring)."""

    def __init__(self, traffic: dict, seed: int, stream: int):
        self.lo = torch.tensor(traffic["x0_low"], dtype=torch.float64)
        self.hi = torch.tensor(traffic["x0_high"], dtype=torch.float64)
        self.a, self.b = traffic["strata"]
        self.gen = torch.Generator().manual_seed((seed * 4 + stream) & SEED_MASK)
        self.queue = torch.empty(0, dtype=torch.int64)

    def draw(self, n: int) -> torch.Tensor:
        cells = self.a * self.b
        while self.queue.numel() < n:
            self.queue = torch.cat([self.queue, torch.randperm(cells, generator=self.gen)])
        idx, self.queue = self.queue[:n], self.queue[n:]
        jitter = torch.rand((n, 2), generator=self.gen, dtype=torch.float64)
        cell = torch.stack([idx // self.b, idx % self.b], dim=1).to(torch.float64)
        frac = (cell + jitter) / torch.tensor([self.a, self.b], dtype=torch.float64)
        return (self.lo + frac * (self.hi - self.lo)).to(torch.float32)


@dataclasses.dataclass
class Window:
    units: int = 0
    lanes: int = 0              # answers: lanes (sweep) or lane-steps
    failed: int = 0             # answers not converged / not usable / not finite
    seconds: float = 0.0
    k1_launches: int = 0
    unit_s: List[float] = dataclasses.field(default_factory=list)    # each unit's wall time
    sample: dict = dataclasses.field(default_factory=dict)           # what the check reads
    trace: object = None
    k1_shapes: List[dict] = dataclasses.field(default_factory=list)
    traced_units: int = 0
    traced_steps: int = 0
    traced_k1_launches: int = 0


def _unit(sut, traffic, x0):
    """Run one unit; returns (answers, failed, its per-lane results)."""
    kind = traffic["kind"]
    if kind == "sweep":
        U, status = sut.solve(x0)
        bad = (status != 1) | ~torch.isfinite(U).all(dim=(1, 2))
        return x0.shape[0], int(bad.sum()), dict(U=U)
    u, x, ok = sut.rollout(x0)
    bad = ~ok | ~torch.isfinite(u).all(dim=-1)
    return ok.numel(), int(bad.sum()), dict(u=u, x=x)


def warm_up(sut, traffic: dict, seed: int) -> None:
    states = InitialStates(traffic, seed, stream=1)
    for _ in range(traffic["warmup_units"]):
        _unit(sut, traffic, states.draw(traffic["batch"]))
    if sut.device != "cpu":
        torch.cuda.synchronize()


def _picker(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed((seed * 4 + 2) & SEED_MASK)


def sample_x0(traffic: dict, seed: int, units: int) -> torch.Tensor:
    """The initial states of the lanes the check of a window of ``units``
    units compares: the same draws and picks as ``run_window``'s."""
    states, picker = InitialStates(traffic, seed, stream=0), _picker(seed)
    B, per = traffic["batch"], traffic["check_per_unit"]
    return torch.cat([states.draw(B)[torch.randperm(B, generator=picker)[:per]]
                      for _ in range(units)])


def run_window(sut, traffic: dict, seed: int, seconds: float, traced: bool) -> Window:
    """The measured window (see the module docstring)."""
    states, picker = InitialStates(traffic, seed, stream=0), _picker(seed)
    B, per = traffic["batch"], traffic["check_per_unit"]
    w = Window()
    kept = {"x0": []}
    k1_at_open = sut.k1_launches()
    n_trace = traffic["trace_units"] if traced else 0
    tracer = contextlib.ExitStack()
    t_open = time.perf_counter()
    t_unit = t_open
    while True:
        x0 = states.draw(B)
        traced_now = w.units < n_trace
        if traced_now and w.units == 0:
            prof = tracer.enter_context(tracing.profiler())
            tracer.enter_context(torch.profiler.record_function(tracing.WINDOW_SPAN))
            tracer.enter_context(sut.k1_shapes(w.k1_shapes))
            k1_traced = sut.k1_launches()
        answers, failed, rows = _unit(sut, traffic, x0)
        if traced_now:
            w.traced_units += 1
            w.traced_steps += traffic.get("steps", 1)
            if w.traced_units == n_trace:
                if sut.device != "cpu":
                    torch.cuda.synchronize()
                tracer.close()
                w.traced_k1_launches = sut.k1_launches() - k1_traced
                w.trace = prof
        w.units += 1
        w.lanes += answers
        w.failed += failed
        pick = torch.randperm(B, generator=picker)[:per]
        kept["x0"].append(x0[pick])
        for k, v in rows.items():
            kept.setdefault(k, []).append(v[pick])
        now = time.perf_counter()
        w.unit_s.append(now - t_unit)
        t_unit = now
        if now - t_open >= seconds and w.traced_units == n_trace:
            break
    w.seconds = time.perf_counter() - t_open
    w.k1_launches = sut.k1_launches() - k1_at_open
    w.sample = {k: torch.cat(v) for k, v in kept.items()}
    return w
