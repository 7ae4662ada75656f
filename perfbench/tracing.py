"""The traced part of a ``--trace 1`` run: ``torch.profiler`` (CPU and CUDA)
over a fixed number of whole units inside the window, reduced to what the
per-layer readers and the result line take.

Device time is the union of the device operations' intervals (overlapping
kernels count once), clipped to the traced window; the window is the span
``perfbench.window`` that the harness opens around the traced units. An
idle gap is labelled by the innermost host operation that was running across
its middle, or ``python`` where none was (the interpreter between
operations).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

import torch

WINDOW_SPAN = "perfbench.window"
K1_NAME = "boxqp_solve"
TOP = 10
# how far back the label search walks among the host operations of a gap
LABEL_LOOKBACK = 4000


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _short(name: str) -> str:
    return name.split("(")[0][:96]


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    n_kernels: int                      # device kernels (copies and sets apart)
    k1_s: List[float]                   # device time of each K1 launch, in order
    device_ops: List[Tuple[str, float]]  # most device time, by name
    idle_gaps: List[Tuple[str, float]]   # most idle time, by the host's operation


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof) -> Trace:
    """The record of a finished profiler run (times in seconds)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    spans = [e for e in events if e.name == WINDOW_SPAN and e.device_type != cuda]
    if len(spans) != 1:
        raise RuntimeError(f"expected one {WINDOW_SPAN} span, found {len(spans)}")
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    # a span (the window's own) shows on the device's timeline too: not device work
    dev = [e for e in events if e.device_type == cuda and e.name != WINDOW_SPAN
           and not getattr(e, "is_user_annotation", False)
           and w0 <= e.time_range.start and e.time_range.end <= w1]
    host = sorted(
        ((e.time_range.start, e.time_range.end, e.name) for e in events
         if e.device_type != cuda and e.name != WINDOW_SPAN
         and e.time_range.end > w0 and e.time_range.start < w1),
        key=lambda t: t[0])
    busy = _merge((e.time_range.start, e.time_range.end) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = {}
    for e in dev:
        key = _short(e.name)
        by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    # idle gaps inside the window, labelled by the host's innermost operation
    starts = [h[0] for h in host]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps: Dict[str, float] = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        label = "python"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - LABEL_LOOKBACK), -1):
            if host[j][1] >= mid:
                label = _short(host[j][2])
                break
        gaps[label] = gaps.get(label, 0.0) + (e - s) / 1e6
    k1 = sorted((e for e in dev if K1_NAME in e.name), key=lambda e: e.time_range.start)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(
        window_s=(w1 - w0) / 1e6,
        busy_s=busy_us / 1e6,
        n_kernels=sum(1 for e in dev if _is_kernel(e.name)),
        k1_s=[(e.time_range.end - e.time_range.start) / 1e6 for e in k1],
        device_ops=[[k, v] for k, v in top(by_name)],
        idle_gaps=[[k, v] for k, v in top(gaps)],
    )
