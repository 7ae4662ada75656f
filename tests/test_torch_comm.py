"""The port's gRPC master service (``control_box_rst_tpu_torch.comm``)
against the JAX package's, on the CPU.

- The seven cases of ``tests/test_comm.py`` against the port's server
  (``MasterServer(device="cpu", dtype=torch.float64)``).
- Cross-wire round trips on ``test_comm.py``'s ``CONFIG`` (T_steps 8, N 6):
  the JAX package's ``MasterClient`` against the port's server, and the
  port's client against the JAX package's server. Each client gets from the
  other package's server the signal tree its own package's server gives:
  the same names, kinds and shapes, values within 1e-6 in float64 (the
  tolerance of ``tests/test_torch_master.py``).
- ``python -m control_box_rst_tpu_torch.master --serve localhost:0 --device
  cpu`` as a subprocess on the config-1 YAML with T_steps cut to 3 (a temp
  copy; ~65 s in float32 on one CPU): its first line names the port;
  ``ping`` and ``performTask`` (the closed loop's signal names, three
  controls in the box).

The generated ``master_service_pb2`` modules of the two packages are
byte-for-byte copies, so in this process they share one descriptor pool and
their message classes.
"""
import copy
import pathlib
import re
import select
import subprocess
import sys
from concurrent import futures

import grpc
import numpy as np
import pytest
import torch
import yaml

from control_box_rst_tpu import comm as jax_comm
from control_box_rst_tpu_torch.comm import MasterClient, MasterServer, pb
from control_box_rst_tpu_torch.comm.service import merge_signal, proto_to_signal, signal_to_protos

from test_comm import CONFIG

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = dict(device="cpu", dtype=torch.float64)
TOL = 1e-6

torch.set_num_threads(1)


def _start(master):
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((master.grpc_handler(),))
    port = server.add_insecure_port("localhost:0")
    server.start()
    return server, f"localhost:{port}"


@pytest.fixture(scope="module")
def client():
    server, address = _start(MasterServer(**F64))
    c = MasterClient(address)
    yield c
    c.close()
    server.stop(grace=None)


def test_ping(client):
    assert client.ping()


def test_config_round_trip(client):
    st = client.set_config(CONFIG)
    assert st.ok, st.text
    task = client.get_section("task")
    assert task["experiment"]["T_steps"] == 8
    ctrl = client.get_section("controller")
    assert ctrl["grid"]["N"] == 6
    assert ctrl["x0"] == [1.0, 0.0]


def test_section_setters_and_validation(client):
    st = client.set_task({"experiment": {"task": "closed_loop", "T_steps": 5, "dt": 0.1}})
    assert st.ok
    # wrong keys for a section are rejected
    st = client.set_plant({"system": {"type": "van_der_pol"}})
    assert not st.ok and "not valid" in st.text
    # malformed YAML is rejected with a status, not a crash
    bad = pb.ComponentConfig(kind="task", yaml="a: [unclosed")
    st = client._stubs["setTask"](bad)
    assert not st.ok and "YAML" in st.text


def test_verify_config(client):
    client.set_config(CONFIG)
    ok, text = client.verify_config()
    assert ok, text
    # controller dims vs plant dims: serial_integrators(2, 1) against
    # van_der_pol(2, 1) match; serial_integrators(3, 1) does not
    broken = copy.deepcopy(CONFIG)
    broken["plant"] = {"system": {"type": "van_der_pol"}}
    broken["cost"] = {"type": "quadratic_form", "Q": [[1.0, 0], [0, 1.0]], "R": [[0.1]]}
    client.set_config(broken)
    ok, text = client.verify_config()
    assert ok, text
    broken["system"] = {"type": "serial_integrators", "params": {"nx": 3, "nu": 1}}
    broken["cost"]["Q"] = np.eye(3).tolist()
    broken["x0"] = [1.0, 0.0, 0.0]
    client.set_config(broken)
    ok, text = client.verify_config()
    assert not ok and "nx" in text, text


def test_available_signals(client):
    client.set_config(CONFIG)
    sigs = client.available_signals()
    assert "plant_output" in sigs and "applied_controls" in sigs


def test_perform_task_streams_signals(client):
    client.set_config(CONFIG)
    ok, text = client.verify_config()
    assert ok, text
    store = client.perform_task()
    assert "master/progress" in store
    for name in ("plant_output", "observed_states", "applied_controls", "plant_states"):
        assert name in store, sorted(store)
    u = store["applied_controls"]["values"]
    assert u.shape[0] == 8
    assert np.all(np.abs(u) <= 1.0 + 1e-6)
    xs = store["plant_states"]["values"]
    assert abs(xs[-1][0]) < abs(xs[0][0])


def test_signal_proto_round_trip():
    sig = {"kind": "time_series", "times": np.arange(3.0),
           "values": np.arange(6.0).reshape(3, 2)}
    msgs = list(signal_to_protos("a/b", sig))
    assert len(msgs) == 1
    name, back = proto_to_signal(msgs[0])
    assert name == "a/b"
    np.testing.assert_allclose(back["values"], sig["values"])
    np.testing.assert_allclose(back["times"], sig["times"])

    mat = {"kind": "matrix", "matrices": [np.eye(2), np.ones((1, 3))]}
    store = {}
    for m in signal_to_protos("m", mat):
        n, s = proto_to_signal(m)
        merge_signal(store, n, s)
    assert len(store["m"]["matrices"]) == 2
    np.testing.assert_allclose(store["m"]["matrices"][1], np.ones((1, 3)))


# -- cross-wire: each package's client against the other's server ----------

@pytest.fixture(scope="module")
def wires():
    """The two packages' servers, each with CONFIG, and the store each
    package's client gets from its own package's server."""
    port_server, port_addr = _start(MasterServer(**F64))
    jax_server, jax_addr = _start(jax_comm.MasterServer())
    own = {}
    for name, cls, addr in (("port", MasterClient, port_addr),
                            ("jax", jax_comm.MasterClient, jax_addr)):
        c = cls(addr)
        assert c.set_config(CONFIG).ok
        own[name] = c.perform_task()
        c.close()
    yield dict(port=port_addr, jax=jax_addr, own=own)
    port_server.stop(grace=None)
    jax_server.stop(grace=None)


def _hold_trees(got, want):
    """Equal names, kinds and shapes; values (and times) within TOL."""
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        assert g["kind"] == w["kind"], name
        for key in ("values", "times"):
            if key in w:
                assert np.shape(g[key]) == np.shape(w[key]), (name, key)
                np.testing.assert_allclose(g[key], w[key], rtol=0, atol=TOL, err_msg=name)
        for gm, wm in zip(g.get("matrices", []), w.get("matrices", [])):
            assert np.shape(gm) == np.shape(wm), name
            np.testing.assert_allclose(gm, wm, rtol=0, atol=TOL, err_msg=name)


def test_jax_client_against_the_port_server(wires):
    c = jax_comm.MasterClient(wires["port"])
    try:
        assert c.ping()
        assert c.set_config(CONFIG).ok
        assert c.get_section("controller")["grid"]["N"] == 6
        ok, text = c.verify_config()
        assert ok, text
        assert c.available_signals() == jax_comm.MasterClient(wires["jax"]).available_signals()
        store = c.perform_task()
    finally:
        c.close()
    _hold_trees(store, wires["own"]["jax"])
    assert store["applied_controls"]["values"].shape == (8, 1)


def test_port_client_against_the_jax_server(wires):
    c = MasterClient(wires["jax"])
    try:
        assert c.ping()
        assert c.set_config(CONFIG).ok
        ok, text = c.verify_config()
        assert ok, text
        store = c.perform_task()
    finally:
        c.close()
    _hold_trees(store, wires["own"]["port"])
    # and the two packages' own runs agree with each other
    _hold_trees(wires["own"]["port"], wires["own"]["jax"])


# -- the entry point: master --serve as a subprocess ------------------------

def _first_line(proc, timeout_s):
    ready, _, _ = select.select([proc.stdout], [], [], timeout_s)
    assert ready, f"no output from master --serve in {timeout_s} s"
    return proc.stdout.readline()


def test_master_serve_subprocess(tmp_path):
    cfg = yaml.safe_load((ROOT / "examples" / "config1_double_integrator.yaml").read_text())
    cfg["experiment"]["T_steps"] = 3
    path = tmp_path / "config1.yaml"
    path.write_text(yaml.safe_dump(cfg))
    proc = subprocess.Popen(
        [sys.executable, "-m", "control_box_rst_tpu_torch.master", "--serve", "localhost:0",
         "--device", "cpu", "--config", str(path)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = _first_line(proc, 120)
        m = re.fullmatch(r"corbo_tpu master listening on localhost:(\d+)\n", line)
        assert m, (line, proc.poll())
        c = MasterClient(f"localhost:{m.group(1)}")
        try:
            assert c.ping()
            assert c.get_section("task")["experiment"]["T_steps"] == 3
            store = c.perform_task()
        finally:
            c.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    assert store["master/progress"]["values"].tolist() == [1.0]  # the last of the two
    u = store["applied_controls"]["values"]
    assert u.shape == (3, 1) and np.all(np.abs(u) <= 1.0 + 1e-6)
    for name in ("plant_output", "observed_states", "plant_states", "controller/sqp_iters"):
        assert name in store, sorted(store)
