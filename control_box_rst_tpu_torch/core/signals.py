"""Named signal tree.

Counterpart of the JAX package's ``core/signals.py``: the host-side sink
that organizes the stacked per-step results of a run into a tree of named
signals ("plant_output", "observed_states", "controller/sqp_iters", …) for
export (``core/export.py``) and inspection. Signals are numpy arrays: a
tensor handed in is copied to the host once, when it is recorded.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A numpy array of ``a`` (a tensor is copied to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class SignalGroup:
    """A namespace node: child groups + named signals (numpy arrays)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.groups: Dict[str, "SignalGroup"] = {}
        self.signals: Dict[str, dict] = {}

    def child(self, name: str) -> "SignalGroup":
        if name not in self.groups:
            self.groups[name] = SignalGroup(name)
        return self.groups[name]


class SignalRecorder:
    """In-memory signal sink. Names are '/'-separated namespaces:
    ``recorder.add_time_series("plant/output", t, y)``."""

    def __init__(self):
        self.root = SignalGroup()

    # -- sink API ----------------------------------------------------------
    def add_measurement(self, name: str, time, values) -> None:
        """Append one time-stamped measurement to a growing signal."""
        sig = self._signal(name, kind="measurement")
        sig.setdefault("times", []).append(float(time))
        sig.setdefault("values", []).append(_np(values))

    def add_time_series(self, name: str, times, values) -> None:
        """Record a complete time series (e.g. stacked per-step results)."""
        sig = self._signal(name, kind="time_series")
        sig["times"] = _np(times)
        sig["values"] = _np(values)

    def add_indexed_values(self, name: str, index, values) -> None:
        sig = self._signal(name, kind="indexed")
        sig.setdefault("indices", []).append(int(index))
        sig.setdefault("values", []).append(_np(values))

    def add_matrix(self, name: str, matrix) -> None:
        sig = self._signal(name, kind="matrix")
        sig.setdefault("matrices", []).append(_np(matrix))

    def record_closed_loop(self, result, prefix: str = "") -> None:
        """Sink the ``ClosedLoopResult`` of ONE rollout with the reference's
        signal names. A batch of one lane (ts [1, T]) is squeezed first; a
        larger batch raises, since the recorder keeps an ``info`` entry only
        when it has at most 2 dims and would drop the per-lane ones."""
        ts = _np(result.ts)
        info = {k: _np(v) for k, v in result.info.items()}
        fields = [_np(a) for a in (result.y, result.x_observed, result.u, result.x_true)]
        if ts.ndim == 2:
            if ts.shape[0] != 1:
                raise ValueError(
                    f"record_closed_loop takes one rollout; got a batch of {ts.shape[0]}")
            ts, fields = ts[0], [a[0] for a in fields]
            info = {k: v[0] for k, v in info.items()}
        y, x_observed, u, x_true = fields
        p = prefix
        self.add_time_series(p + "plant_output", ts, y)
        self.add_time_series(p + "observed_states", ts, x_observed)
        self.add_time_series(p + "applied_controls", ts, u)
        self.add_time_series(p + "plant_states", np.append(ts, ts[-1] + (ts[1] - ts[0]) if len(ts) > 1 else ts), x_true)
        for k, arr in info.items():
            if arr.ndim <= 2:
                self.add_time_series(p + f"controller/{k}", ts, arr)

    # -- access ------------------------------------------------------------
    def get(self, name: str) -> dict:
        group, leaf = self._walk(name)
        return group.signals[leaf]

    def names(self) -> Iterable[str]:
        out = []

        def rec(g: SignalGroup, prefix: str):
            for s in g.signals:
                out.append(prefix + s)
            for name, child in g.groups.items():
                rec(child, prefix + name + "/")

        rec(self.root, "")
        return out

    # -- internals ---------------------------------------------------------
    def _walk(self, name: str):
        parts = name.split("/")
        group = self.root
        for p in parts[:-1]:
            group = group.child(p)
        return group, parts[-1]

    def _signal(self, name: str, kind: str) -> dict:
        group, leaf = self._walk(name)
        sig = group.signals.setdefault(leaf, {"kind": kind, "name": name})
        return sig
