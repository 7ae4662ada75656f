"""The port's dashboard and scope (``control_box_rst_tpu_torch.gui``) on
the CPU: the four cases of ``tests/test_gui.py`` against the port's gRPC
master (``MasterServer(device="cpu", dtype=torch.float64)``) and the port's
``DashboardServer``, and the port's ``SignalBuffer`` against the JAX
package's on the same ingests (``tree()`` equal, ``series()`` equal)."""
import json
import os
import urllib.request
from concurrent import futures

import grpc
import numpy as np
import pytest
import torch
import yaml

from control_box_rst_tpu.gui import SignalBuffer as JaxSignalBuffer
from control_box_rst_tpu_torch.comm import MasterServer
from control_box_rst_tpu_torch.gui import SignalBuffer, save_scope_png
from control_box_rst_tpu_torch.gui.app import DashboardServer

from test_gui import CONFIG

torch.set_num_threads(1)


def _ingests():
    ts = np.linspace(0, 5, 50)
    return [
        ("plant/output", {"kind": "time_series", "times": np.arange(4.0),
                          "values": np.ones((4, 2))}),
        ("controller/obj", {"kind": "time_series", "times": np.arange(4.0),
                            "values": np.arange(4.0)}),
        ("bench/mats", {"kind": "matrix", "matrices": [np.eye(2)], "indices": [0]}),
        ("bench/mats", {"kind": "matrix", "matrices": [np.eye(2)], "indices": [1]}),
        ("x", {"kind": "time_series", "times": ts,
               "values": np.stack([np.sin(ts), np.cos(ts)], -1)}),
        ("short", {"kind": "time_series", "times": np.arange(2.0),
                   "values": np.arange(6.0).reshape(3, 2)}),
        ("idx", {"kind": "indexed", "indices": [3, 5], "values": np.arange(4.0).reshape(2, 2)}),
        ("m/meas", {"kind": "measurement", "times": [0.0], "values": [[1.5]]}),
        ("empty", {"kind": "time_series", "times": [], "values": []}),
    ]


def test_signal_buffer_tree_and_series():
    buf = SignalBuffer()
    for name, sig in _ingests()[:4]:
        buf.ingest(name, sig)
    tree = buf.tree()
    assert tree["plant"]["output"] == "time_series"
    assert tree["bench"]["mats"] == "matrix"
    t, v = buf.series("plant/output")
    assert v.shape == (4, 2)
    t, v = buf.series("controller/obj")
    assert v.shape == (4, 1)
    assert buf.series("bench/mats") is None  # matrices aren't scope series
    assert len(buf.get("bench/mats")["matrices"]) == 2
    assert "plant/output" in buf.plottable()


def test_signal_buffer_equals_the_jax_package():
    ours, ref = SignalBuffer(), JaxSignalBuffer()
    for name, sig in _ingests():
        ours.ingest(name, dict(sig))
        ref.ingest(name, dict(sig))
    assert ours.tree() == ref.tree()
    assert ours.names() == ref.names() and list(ours.plottable()) == list(ref.plottable())
    for name in ref.names():
        a, b = ours.series(name), ref.series(name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_scope_png(tmp_path):
    buf = SignalBuffer()
    ts = np.linspace(0, 5, 50)
    buf.ingest("x", {"kind": "time_series", "times": ts,
                     "values": np.stack([np.sin(ts), np.cos(ts)], -1)})
    buf.ingest("u", {"kind": "time_series", "times": ts, "values": np.sign(np.sin(3 * ts))})
    path = save_scope_png(buf, str(tmp_path / "scope.png"))
    assert os.path.getsize(path) > 5000  # a real rendered figure


@pytest.fixture(scope="module")
def dashboard():
    master = MasterServer(device="cpu", dtype=torch.float64)
    master.set_section("config", yaml.safe_dump(CONFIG))
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((master.grpc_handler(),))
    port = server.add_insecure_port("localhost:0")
    server.start()

    dash = DashboardServer(f"localhost:{port}", http_port=0, ws_port=0)
    dash.start()
    # ws_port=0 binds an ephemeral port; read it back from the socket
    ws_port = dash._ws_server.socket.getsockname()[1]
    yield dash, ws_port
    dash.stop()
    server.stop(grace=None)


def test_dashboard_serves_page(dashboard):
    dash, ws_port = dashboard
    html = urllib.request.urlopen(
        f"http://localhost:{dash.http_port}/", timeout=5
    ).read().decode()
    assert "corbo_tpu" in html and "WebSocket" in html


def test_dashboard_ws_bridge_full_flow(dashboard):
    from websockets.sync.client import connect

    dash, ws_port = dashboard
    with connect(f"ws://localhost:{ws_port}/", open_timeout=10) as ws:
        def rpc(cmd, **kw):
            ws.send(json.dumps({"cmd": cmd, **kw}))
            return json.loads(ws.recv(timeout=180))

        st = rpc("ping")
        assert st["type"] == "status" and st["ok"], st

        sections = rpc("sections")
        assert "T_steps: 6" in sections["sections"]["task"]

        st = rpc("set_section", kind="task",
                 yaml="experiment:\n  task: closed_loop\n  T_steps: 7\n  dt: 0.1\n")
        assert st["ok"], st

        st = rpc("verify")
        assert st["ok"], st

        avail = rpc("available")
        assert "plant_output" in avail["signals"]

        # run: collect the streamed signal messages until run_done
        ws.send(json.dumps({"cmd": "run"}))
        got = {}
        while True:
            m = json.loads(ws.recv(timeout=300))
            if m["type"] == "run_done":
                break
            assert m["type"] == "signal", m
            got[m["name"]] = m
        assert "applied_controls" in got and "plant_states" in got
        u = np.asarray(got["applied_controls"]["values"]).reshape(
            got["applied_controls"]["shape"])
        assert u.shape[0] == 7
        assert np.all(np.abs(u) <= 1.0 + 1e-5)

        # probe: unknown command → status error, connection stays usable
        st = rpc("frobnicate")
        assert not st["ok"]
        assert rpc("ping")["ok"]
