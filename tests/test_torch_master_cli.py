"""The port's master CLI against the JAX package's, on the CPU.

``python -m control_box_rst_tpu_torch.master --config … --device cpu --out
…`` (a 3-step closed loop of ``tests/test_config_extended.py``'s base
config) writes the reference master's set of files: the same TSV names
with the same numbers of rows and columns, ``signals.yaml`` with the same
tree, ``config.json`` equal. Without ``--device`` on a machine with no card
the master raises before it writes anything, and so does
``run_experiment``; so does ``--serve``, before it binds a port.
"""
import copy
import json
import os
import subprocess
import sys

import jax  # noqa: F401 (the test configuration: CPU, x64)
import pytest
import torch
import yaml

from control_box_rst_tpu_torch.core import config as tc

from torch_master_util import EXT_BASE, ROOT, _with

torch.set_num_threads(1)


def _tsv_shapes(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            rows = [line.rstrip("\n").split("\t") for line in f]
        out[name] = (len(rows), sorted({len(r) for r in rows}))
    return out


def test_master_cli_writes_the_reference_files(tmp_path):
    from control_box_rst_tpu.master import main as jmain

    cfg = _with(EXT_BASE, experiment={"task": "closed_loop", "T_steps": 3, "dt": 0.1})
    path = tmp_path / "exp.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert jmain(["--config", str(path), "--out", str(tmp_path / "j"), "--format", "both"]) == 0
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "control_box_rst_tpu_torch.master", "--config", str(path),
         "--device", "cpu", "--out", str(tmp_path / "t"), "--format", "both",
         "--print-signals"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "applied_controls: kind=time_series" in proc.stdout
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    assert _tsv_shapes(tmp_path / "t" / "signals") == _tsv_shapes(tmp_path / "j" / "signals")
    tree = lambda p: yaml.safe_load((p / "signals.yaml").read_text())
    kinds = lambda t: {k: kinds(v) if "kind" not in v else v["kind"] for k, v in t.items()}
    assert kinds(tree(tmp_path / "t")) == kinds(tree(tmp_path / "j"))
    assert json.loads((tmp_path / "t" / "config.json").read_text()) == json.loads(
        (tmp_path / "j" / "config.json").read_text())


def test_master_refuses_without_a_card_and_refuses_serve(tmp_path, monkeypatch):
    from control_box_rst_tpu_torch import master

    path = tmp_path / "exp.yaml"
    path.write_text(yaml.safe_dump(EXT_BASE))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        master.main(["--config", str(path), "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.run_experiment(copy.deepcopy(EXT_BASE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        master.main(["--serve", "localhost:0", "--config", str(path)])
