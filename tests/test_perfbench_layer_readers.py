"""The benchmark's readers of the port's layer spans and counters, on the
CPU: a traced run of each cell at a tiny size (``perfbench/run.py``'s
``run_cell``) reports every per-layer metric of its cell that reads the
port's record as a finite number, and the readers of the device trace what
they read on the CPU without the spans: an idle device, and no K1 launch to
count. The box-QP wrapper's path is taken as on the card (its plain version
runs on the CPU). Where the port keeps no record, as before it had spans,
every new reader returns nothing."""
import math

import pytest

from control_box_rst_tpu_torch.control import predictive
from control_box_rst_tpu_torch.parallel import sharded_solve
from control_box_rst_tpu_torch.utils import profiling
from perfbench import run, spec
from perfbench.record import Record

NEAR = dict(x0_low=[-0.05, -0.05], x0_high=[0.05, 0.05], warmup_units=0,
            check_per_unit=1, trace_units=1)
SMALL = {
    "di_h50.sweep": dict(NEAR, batch=8, strata=[2, 4]),
    "vdp_ms_h20.sweep": dict(NEAR, batch=4, strata=[2, 2]),
    "di_h50.rollouts": dict(NEAR, batch=4, strata=[2, 2], steps=2),
}
SPAN_READERS = {
    "di_h50.sweep": ["entry_host_ms.solves", "transcription_host_ms.solves",
                     "sqp_host_ms.solves", "stage_qp_host_ms.solves",
                     "sqp_lane_iter_pct.solves", "host_wait_pct.solves"],
    "di_h50.rollouts": ["host_wait_pct.rollouts", "controller_host_ms.rollouts",
                        "step_replay_pct.rollouts"],
}
SPAN_READERS["vdp_ms_h20.sweep"] = SPAN_READERS["di_h50.sweep"]
# the device-trace readers on the CPU: an idle device, no K1 launch counted
DEVICE_READERS = {
    "di_h50.sweep": {"device_idle_pct.solves": 100.0},
    "vdp_ms_h20.sweep": {"device_idle_pct.solves": 100.0},
    "di_h50.rollouts": {"device_idle_pct.rollouts": 100.0},
}


def fused(cfg, ng, device, dtype):
    return cfg.replace(qp=cfg.qp.replace(backend="fused"))


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_traced_run_reads_every_layer(workload, monkeypatch):
    monkeypatch.setattr(sharded_solve, "resolve_qp_backend", fused)
    monkeypatch.setattr(predictive, "resolve_qp_backend", fused)
    result, _ = run.run_cell(workload, 2**31 + 11, 0.0, True, device="cpu",
                             traffic_overrides=SMALL[workload], setup_clock=lambda: 0.0)
    assert result["correct"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    for name in SPAN_READERS[workload]:
        assert math.isfinite(metrics.pop(name)), name
    assert metrics == DEVICE_READERS[workload]
    assert {m["name"] for m in spec.cell(workload).per_layer} >= set(SPAN_READERS[workload])


def test_without_the_ports_record_the_readers_return_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "last_record")
    record = Record(kind="sweep", window_s=1.0, busy_s=0.5, n_kernels=10, k1_s=[],
                    k1_shapes=[], traced_units=1, traced_steps=1, traced_k1_launches=0,
                    units=1, k1_launches=0)
    names = {n for names in SPAN_READERS.values() for n in names}
    assert len(names) == 9
    for name in sorted(names):
        assert spec.reader(name)(record) is None, name


@pytest.mark.parametrize("graphed, share", [(False, 0.0), (True, 100.0)])
def test_step_replay_pct_reads_the_share_of_replayed_steps(graphed, share, monkeypatch):
    """The traced rollouts cell on the CPU steps eagerly: 0 %. With the step
    graphs engaged (on the CPU their two parts run as plain calls) every
    traced step is a replayed one: 100 %, and the run stays correct."""
    monkeypatch.setattr(sharded_solve, "resolve_qp_backend", fused)
    monkeypatch.setattr(predictive, "resolve_qp_backend", fused)
    monkeypatch.setattr(sharded_solve, "graph_engages", lambda *args: graphed)
    result, _ = run.run_cell("di_h50.rollouts", 2**31 + 13, 0.0, True, device="cpu",
                             traffic_overrides=SMALL["di_h50.rollouts"],
                             setup_clock=lambda: 0.0)
    assert result["correct"]
    assert result["metrics"]["step_replay_pct.rollouts"]["value"] == share
    assert math.isfinite(result["metrics"]["controller_host_ms.rollouts"]["value"])
