"""BENCHMARK.json and the files it names: the contract's names and units,
each per-layer metric in cells that report what it moves, and new cells,
configurations, mixes and metrics found by name with no edit."""
import json
import shutil

import pytest

from perfbench import spec

BENCH = spec.load_json(spec.benchmark_path())


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for m in BENCH[key]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(spec.NAME.match(n) for n in names), [n for n in names if not spec.NAME.match(n)]
    units = [m["unit"] for key in ("end_to_end", "per_layer") for m in BENCH[key]]
    assert all(spec.UNIT.match(u) for u in units)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({m["name"] for m in BENCH[key]}) == len(BENCH[key])


def test_every_cell_reports_setup_a_rate_or_tail_and_a_layer():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]


def test_every_per_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w]), (m["name"], w)


def test_every_cell_and_metric_has_its_files():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.limits and all(v > 0 for v in cell.limits.values())
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in BENCH["configs"]:
        assert spec.load_json(spec.benchmark_path().parent / c["file"])["source"] == c["source"]


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark's files to drop new ones into."""
    root = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(spec.HERE / sub, root / sub)
    return root


def test_a_new_cell_config_mix_and_metric_are_found_by_name(copy):
    cfg = json.loads((copy / "configs" / "di_h50.json").read_text())
    cfg.update(name="di_h30", grid=dict(cfg["grid"], N=30))
    (copy / "configs" / "di_h30.json").write_text(json.dumps(cfg))
    mix = json.loads((copy / "traffic" / "sweep_b4096_wide.json").read_text())
    (copy / "traffic" / "sweep_b1024.json").write_text(json.dumps(dict(mix, batch=1024)))
    (copy / "limits" / "di_h30.sweep_b1024.json").write_text(
        '{"u_gap": 0.004, "failed_share": 0.01}')
    (copy / "metrics" / "batches_per_s.py").write_text(
        "def read(record):\n    return record.units / record.window_s\n")
    bench = json.loads(spec.benchmark_path().read_text())
    bench["workloads"].append(dict(name="di_h30.sweep_b1024", config="di_h30",
                                   traffic="sweep_b1024", chips=1, why="test"))
    bench["end_to_end"][0]["workloads"].append("di_h30.sweep_b1024")
    bench["per_layer"].append(dict(name="batches_per_s", unit="1/s", better="higher",
                                   source="host_clock", layer="entry", moves="solves_per_s",
                                   workloads=["di_h30.sweep_b1024"]))
    cell = spec.cell("di_h30.sweep_b1024", root=copy, bench=bench)
    assert cell.config["grid"]["N"] == 30 and cell.traffic["batch"] == 1024
    assert cell.limits == {"u_gap": 0.004, "failed_share": 0.01}
    assert [m["name"] for m in cell.per_layer][-1] == "batches_per_s"
    rec = type("R", (), dict(units=6, window_s=2.0))
    assert spec.reader("batches_per_s", root=copy)(rec) == 3.0


def test_a_dotted_metric_falls_back_to_its_stem_and_prefers_its_own_file(copy):
    rec = type("R", (), dict(window_s=2.0, busy_s=0.5))
    assert spec.reader("device_idle_pct.anything", root=copy)(rec) == 75.0
    (copy / "metrics" / "device_idle_pct.anything.py").write_text(
        "def read(record):\n    return 1.0\n")
    assert spec.reader("device_idle_pct.anything", root=copy)(rec) == 1.0
