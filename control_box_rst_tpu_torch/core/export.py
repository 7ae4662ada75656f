"""Signal-tree exporters.

Counterpart of the JAX package's ``core/export.py``: ``export_tsv`` writes
one file per signal (the same file names, columns and ``%.9g`` numbers as
the reference's), ``export_yaml`` the whole tree as one YAML document.
"""
from __future__ import annotations

import os

import numpy as np

from control_box_rst_tpu_torch.core.signals import SignalGroup, SignalRecorder


def _sig_to_plain(sig: dict):
    out = {"kind": sig["kind"]}
    for key in ("times", "values", "indices", "matrices"):
        if key in sig:
            out[key] = np.asarray(sig[key]).tolist()
    return out


def export_yaml(recorder: SignalRecorder, path: str) -> None:
    """Write the whole signal tree as YAML."""
    import yaml

    def rec(group: SignalGroup):
        node = {}
        for name, sig in group.signals.items():
            node[name] = _sig_to_plain(sig)
        for name, child in group.groups.items():
            node[name] = rec(child)
        return node

    with open(path, "w") as f:
        yaml.safe_dump(rec(recorder.root), f, default_flow_style=None)


def export_tsv(recorder: SignalRecorder, directory: str) -> None:
    """Write one TSV file per signal ('/' in a name becomes '__'): first
    column the time (the index for indexed signals, the matrix index for
    matrices), then the components."""
    os.makedirs(directory, exist_ok=True)
    for name in recorder.names():
        sig = recorder.get(name)
        fname = os.path.join(directory, name.replace("/", "__") + ".tsv")
        kind = sig.get("kind", "time_series")
        if kind == "matrix":
            # one row per matrix: index column, then the flattened matrix
            mats = sig.get("matrices", [])
            idx = sig.get("indices", list(range(len(mats))))
            with open(fname, "w") as f:
                for i, m in zip(idx, mats):
                    row = [f"{i:.9g}"] + [
                        f"{v:.9g}" for v in np.ravel(np.asarray(m))
                    ]
                    f.write("\t".join(row) + "\n")
            continue
        if kind == "indexed":
            first_col = np.atleast_1d(
                np.asarray(sig.get("indices", []), dtype=np.float64)
            )
        else:
            first_col = np.atleast_1d(np.asarray(sig.get("times", [])))
        values = np.asarray(sig.get("values", []))
        if values.ndim == 1:
            values = values[:, None]
        n = min(len(first_col), len(values)) if len(first_col) else len(values)
        with open(fname, "w") as f:
            for i in range(n):
                row = [f"{first_col[i]:.9g}"] if len(first_col) else []
                row += [f"{v:.9g}" for v in np.ravel(values[i])]
                f.write("\t".join(row) + "\n")
