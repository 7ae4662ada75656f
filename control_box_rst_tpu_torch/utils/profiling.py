"""Profiling and phase-timing utilities.

Counterpart of the JAX package's ``utils/profiling.py``: a host-side phase
timer whose results slot into the signal recorder, and a device trace.
``PhaseTimer.phase(..., block_on=...)`` waits for the device that holds the
tensors in ``block_on`` before it stops the clock (the reference's
``jax.block_until_ready``); ``device_trace`` runs ``torch.profiler`` over the
CPU and, where there is a card, CUDA activities and writes a Chrome trace
(the reference's ``jax.profiler`` trace).

Layer spans and counters: ``span(name)`` marks a layer boundary of the
program (``<layer>.<what>``: ``entry.solve``, ``sqp.line_search``, ...) and
``count(name, n)`` counts work at the same boundaries. Both record exactly
while a ``torch.profiler`` session records, and nothing otherwise: a span is
then a flag test, enters no ``record_function`` and touches no tensor. While
a session records, a span enters ``record_function(name)``, so it shows in
the profiler's trace, and keeps ``(name, start_ns, end_ns, parent, root)``
on ``time.perf_counter_ns`` (CLOCK_MONOTONIC) in the session's
``SpanRecord``: ``parent`` is the enclosing span of the same thread,
``root`` the outermost one. Each session starts a fresh record;
``last_record()`` returns the one of the running or the last session.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import sys
import threading
import time
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler


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
    Chrome trace (chrome://tracing, Perfetto), which holds the program's
    layer spans (``span``); ``last_record()`` holds them after the block."""
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


class SpanRecord:
    """The spans and counters of one profiler session."""

    def __init__(self):
        # span id -> (name, start_ns, end_ns, parent id, root id)
        self.spans: Dict[int, tuple] = {}
        self.counts: Dict[str, int] = {}
        self.kept = []  # (name, tensor): summed when the record is read
        self._lock = threading.Lock()

    def count(self, name: str, n) -> None:
        with self._lock:
            if isinstance(n, torch.Tensor):
                self.kept.append((name, n))
            else:
                self.counts[name] = self.counts.get(name, 0) + n

    def self_ns(self) -> Dict[int, int]:
        """Each span's duration minus the part its child spans cover."""
        spans = list(self.spans.items())
        own = {sid: end - start for sid, (_, start, end, _, _) in spans}
        for _, (_, start, end, parent, _) in spans:
            if parent in own:
                own[parent] -= end - start
        return own

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name: ``count`` and ``total_s`` (as ``PhaseTimer.summary``)
        and ``self_s``."""
        own = self.self_ns()
        acc: Dict[str, list] = {}
        for sid, (name, start, end, _, _) in list(self.spans.items()):
            a = acc.setdefault(name, [0, 0, 0])
            a[0] += 1
            a[1] += end - start
            a[2] += own[sid]
        return {
            name: {"count": n, "total_s": total * 1e-9, "self_s": own_ns * 1e-9}
            for name, (n, total, own_ns) in acc.items()
        }

    def counters(self) -> Dict[str, int]:
        """Every counter's total; a kept tensor is summed here (on the
        device that holds it, then copied to the host)."""
        with self._lock:
            out, kept = dict(self.counts), list(self.kept)
        for name, t in kept:
            out[name] = out.get(name, 0) + int(t.sum())
        return out


_record = SpanRecord()
_span_ids = itertools.count()
_local = threading.local()  # .stack: the open spans of a thread


def last_record() -> SpanRecord:
    """The record of the profiler session that runs now, or of the last one."""
    return _record


def _new_record(*_) -> None:
    global _record
    _record = SpanRecord()


def _watch_sessions() -> None:
    """Start a fresh record with every profiler session: a ``sys.monitoring``
    callback on the start of the function torch's profilers call as a
    session starts recording. Without a free tool id sessions share one
    record."""
    start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
    mon = getattr(sys, "monitoring", None)
    if start is None or mon is None:
        return
    for tool in (4, 3):
        if mon.get_tool(tool) is None:
            mon.use_tool_id(tool, "control_box_rst_tpu_torch.utils.profiling")
            mon.register_callback(tool, mon.events.PY_START, _new_record)
            mon.set_local_events(tool, start.__code__, mon.events.PY_START)
            return


_watch_sessions()


class _Span:
    """One span name; what an entry records lives on its thread's stack."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        on = _autograd_profiler._is_profiler_enabled
        stack = getattr(_local, "stack", None)
        if not on and not stack:
            return self
        if stack is None:
            stack = _local.stack = []
        parent, root = (stack[-1][0], stack[-1][2]) if stack else (None, None)
        if not on:
            # the session ended inside an open span: keep the thread's
            # stack paired with its exits, record nothing
            stack.append((parent, None, root, None, 0, None))
            return self
        sid = next(_span_ids)
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        stack.append((sid, parent, sid if root is None else root, rf,
                      time.perf_counter_ns(), _record))
        return self

    def __exit__(self, *exc):
        stack = getattr(_local, "stack", None)
        if not stack:
            return False
        sid, parent, root, rf, start, record = stack.pop()
        if rf is not None:
            end = time.perf_counter_ns()
            rf.__exit__(*exc)
            record.spans[sid] = (self.name, start, end, parent, root)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return spanned


_SPANS: Dict[str, _Span] = {}


def span(name: str) -> _Span:
    """The span ``name``: a context manager, and a decorator of a function
    whose every call it spans. One shared object per name; while no
    profiler session records, entering it tests a flag and does nothing."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS.setdefault(name, _Span(name))
    return s


def recording() -> bool:
    """True while a profiler session records (what ``span`` and ``count``
    test)."""
    return _autograd_profiler._is_profiler_enabled


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session records.
    A tensor ``n`` is kept by reference and summed when the record is read
    (``SpanRecord.counters``), so counting it launches nothing and waits for
    nothing."""
    if _autograd_profiler._is_profiler_enabled:
        _record.count(name, n)
