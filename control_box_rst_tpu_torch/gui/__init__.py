"""GUI: web dashboard + scope rendering for the master service.

Counterpart of the JAX package's ``gui/``: ``gui.app`` serves a single-page
client (canvas scopes, YAML parameter editors) and bridges it to the gRPC
master over a websocket, forwarding ``performTask`` signals live;
``gui.scope`` renders signal trees to matplotlib figures for headless or
report use.

Run:  python -m control_box_rst_tpu_torch.gui --master localhost:50051 --port 8089
"""
from control_box_rst_tpu_torch.gui.scope import render_signals, save_scope_png
from control_box_rst_tpu_torch.gui.signal_helper import SignalBuffer

__all__ = ["render_signals", "save_scope_png", "SignalBuffer"]
