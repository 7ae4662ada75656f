"""Client-side signal buffering.

Counterpart of the JAX package's ``gui/signal_helper.py`` (the reference
GUI's SignalHelper): the buffer between the RPC stream and the scopes. It
accumulates streamed signals by name, tracks dimensions and hands plot-ready
series to the scopes.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class SignalBuffer:
    """Accumulates streamed signal messages into plot-ready series."""

    def __init__(self):
        self._store: Dict[str, dict] = {}

    def ingest(self, name: str, sig: dict) -> None:
        """Merge one signal entry (recorder-dict form, see comm.service)."""
        kind = sig.get("kind", "time_series")
        cur = self._store.get(name)
        if cur is None or kind != "matrix":
            self._store[name] = dict(sig)
            return
        cur.setdefault("matrices", []).extend(sig.get("matrices", []))
        cur.setdefault("indices", []).extend(sig.get("indices", []))

    def names(self) -> List[str]:
        return sorted(self._store)

    def tree(self) -> dict:
        """Names organized as a '/'-separated namespace tree (the GUI's
        signal-tree widget)."""
        root: dict = {}
        for name in self.names():
            node = root
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = self._store[name]["kind"]
        return root

    def series(self, name: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(times, values[T, D]) for plottable signals, None otherwise."""
        sig = self._store.get(name)
        if sig is None:
            return None
        kind = sig.get("kind")
        if kind in ("time_series", "measurement"):
            v = np.asarray(sig.get("values", []), dtype=np.float64)
            t = np.asarray(sig.get("times", []), dtype=np.float64)
            if v.ndim == 0 or v.size == 0:
                return None
            if v.ndim == 1:
                v = v[:, None]
            v = v.reshape(v.shape[0], -1)
            if t.size != v.shape[0]:
                t = np.arange(v.shape[0], dtype=np.float64)
            return t, v
        if kind == "indexed":
            v = np.asarray(sig.get("values", []), dtype=np.float64)
            idx = np.asarray(sig.get("indices", []), dtype=np.float64)
            if v.ndim == 1:
                v = v[:, None]
            v = v.reshape(v.shape[0], -1) if v.size else v
            if idx.size != v.shape[0]:
                idx = np.arange(v.shape[0], dtype=np.float64)
            return idx, v
        return None

    def get(self, name: str) -> dict:
        return self._store[name]

    def plottable(self) -> Iterable[str]:
        return [n for n in self.names() if self.series(n) is not None]
