"""What a run is asked to do, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells; everything
that belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own under ``perfbench/``, found from the name alone:

    configs/<config>.json     the deployment as it runs, and its source
    traffic/<traffic>.json    the parameters the one generator reads
    limits/<workload>.json    the limit of each number the check compares
    metrics/<metric>.py       the reader of a per-layer metric; a metric
                              ``a.b`` without a file of its own is read by
                              ``metrics/a.py``

Adding a configuration, a mix, a cell or a metric adds files and entries and
edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
from typing import Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]   # the metrics this cell reports with --trace 0
    per_layer: List[dict]    # the metrics this cell reports with --trace 1


def benchmark_path(root: pathlib.Path = HERE) -> pathlib.Path:
    return root.parent / "BENCHMARK.json"


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: pathlib.Path = HERE, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files (``root``: the
    benchmark's folder)."""
    bench = bench if bench is not None else load_json(benchmark_path(root))
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = matches[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in names]
    return Cell(
        name=name,
        config=load_json(root / "configs" / f"{w['config']}.json"),
        traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(root / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=layer,
    )


def reader(metric: str, root: pathlib.Path = HERE) -> Callable:
    """The ``read(record)`` function of a per-layer metric's file."""
    path = root / "metrics" / f"{metric}.py"
    if not path.exists():
        path = root / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
