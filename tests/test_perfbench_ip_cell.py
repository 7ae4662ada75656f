"""The benchmark's cell ``di_h50_ip.sweep`` (config 1 by interior point) on
the CPU at a tiny batch, through ``perfbench/run.py``'s ``run_cell``: an
untraced run comes out correct, a traced run reads the cell's four span and
counter metrics as finite numbers (the kernel count is the card's: none on
the CPU), an answer altered in ``make_batched_ip_solver``'s result comes out
not correct, and where the port keeps no record the five new readers return
nothing."""
import math

import pytest

from control_box_rst_tpu_torch.parallel import sharded_solve
from control_box_rst_tpu_torch.utils import profiling
from perfbench import run, spec
from perfbench.record import Record

CELL = "di_h50_ip.sweep"
SMALL = dict(batch=8, strata=[2, 4], warmup_units=0, check_per_unit=4, trace_units=1)
SPAN_READERS = ["ip_lockstep_iters.solves", "ip_lane_iter_pct.solves", "ip_host_ms.solves",
                "ip_wait_pct.solves"]
NEW_READERS = SPAN_READERS + ["kernels_per_ip_iter.solves"]


def cell_run(traced: bool):
    result, _ = run.run_cell(CELL, 2**31 + 13, 0.0, traced, device="cpu",
                             traffic_overrides=SMALL, setup_clock=lambda: 0.0)
    return result


def test_the_cell_is_correct_and_reports_its_rate():
    result = cell_run(False)
    assert result["correct"]
    assert result["failed"] == 0 and result["attempted"] == SMALL["batch"]
    assert set(result["metrics"]) == {"solves_per_s", "setup_s"}


def test_a_traced_run_reads_the_ip_layer():
    result = cell_run(True)
    assert result["correct"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == set(SPAN_READERS)
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    assert 0 < metrics["ip_lane_iter_pct.solves"] <= 100
    assert metrics["ip_lockstep_iters.solves"] >= 1
    assert {m["name"] for m in spec.cell(CELL).per_layer} == set(NEW_READERS)


def test_an_altered_answer_is_not_correct(monkeypatch):
    real = sharded_solve.make_batched_ip_solver

    def altered(*args, **kw):
        solve = real(*args, **kw)

        def wrong(x0s):
            U, objective, status, iterations = solve(x0s)
            return U + 1e-2, objective, status, iterations

        return wrong

    monkeypatch.setattr(sharded_solve, "make_batched_ip_solver", altered)
    assert not cell_run(False)["correct"]


@pytest.mark.parametrize("name", NEW_READERS)
def test_without_the_ports_record_the_readers_return_nothing(name, monkeypatch):
    monkeypatch.delattr(profiling, "last_record")
    record = Record(kind="sweep", window_s=1.0, busy_s=0.5, n_kernels=10, k1_s=[],
                    k1_shapes=[], traced_units=1, traced_steps=1, traced_k1_launches=0,
                    units=1, k1_launches=0)
    assert spec.reader(name)(record) is None
