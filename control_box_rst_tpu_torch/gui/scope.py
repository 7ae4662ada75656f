"""Scope rendering: signal trees → matplotlib figures.

Counterpart of the JAX package's ``gui/scope.py`` (the reference GUI's
ScopeWidget): headless rendering (matplotlib's Agg backend) of a
SignalBuffer, a SignalRecorder or a client's signal store, one axis per
signal, for reports and the CLI.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from control_box_rst_tpu_torch.gui.signal_helper import SignalBuffer


def _as_buffer(signals) -> SignalBuffer:
    if isinstance(signals, SignalBuffer):
        return signals
    buf = SignalBuffer()
    if hasattr(signals, "names") and hasattr(signals, "get"):  # SignalRecorder
        for name in signals.names():
            buf.ingest(name, signals.get(name))
    elif isinstance(signals, dict):  # comm client store
        for name, sig in signals.items():
            buf.ingest(name, sig)
    else:
        raise TypeError(f"cannot render {type(signals)}")
    return buf


def render_signals(
    signals,
    names: Optional[Sequence[str]] = None,
    title: str = "",
    figsize_per_axis: float = 2.2,
):
    """Render selected signals, one stacked scope per signal.

    `signals` is a SignalBuffer, core.signals.SignalRecorder, or the dict
    returned by comm.MasterClient.perform_task(). Returns the Figure.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    buf = _as_buffer(signals)
    names = list(names) if names is not None else list(buf.plottable())
    names = [n for n in names if buf.series(n) is not None]
    if not names:
        raise ValueError("no plottable signals")
    fig, axes = plt.subplots(
        len(names), 1, sharex=True,
        figsize=(9, max(2.5, figsize_per_axis * len(names))),
        squeeze=False,
    )
    for ax, name in zip(axes[:, 0], names):
        t, v = buf.series(name)
        for d in range(v.shape[1]):
            ax.step(t, v[:, d], where="post", lw=1.2,
                    label=f"[{d}]" if v.shape[1] > 1 else None)
        ax.set_ylabel(name, fontsize=8)
        ax.grid(True, alpha=0.3)
        if v.shape[1] > 1:
            ax.legend(fontsize=7, loc="upper right")
    axes[-1, 0].set_xlabel("time [s]")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    return fig


def save_scope_png(signals, path: str, names: Optional[Sequence[str]] = None,
                   title: str = "", dpi: int = 110) -> str:
    """Render and save to PNG; returns the path."""
    fig = render_signals(signals, names=names, title=title)
    fig.savefig(path, dpi=dpi)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path
