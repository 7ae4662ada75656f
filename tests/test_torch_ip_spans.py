"""The interior-point solver's layer spans and counters on the CPU (config 1
at N=12, float32, 8 lanes): the answers are the same bits with and without
a profiler session; under one, ``ip.lockstep_iters`` is the slowest lane's
iteration count, ``ip.lane_iters`` the sum of the lanes' counts and
``ip.lane_slots`` lanes × lock-step iterations, and the spans nest as the
readers assume; without one, nothing records."""
import torch
from torch.profiler import ProfilerActivity, profile

from control_box_rst_tpu_torch import entry
from control_box_rst_tpu_torch.parallel import make_batched_solver
from control_box_rst_tpu_torch.utils import profiling
from control_box_rst_tpu_torch.utils.profiling import last_record

B = 8


def solver():
    ocp, cfg = entry.flagship_ip(12, device="cpu")
    gen = torch.Generator().manual_seed(23)
    x0 = torch.rand((B, 2), generator=gen) * 2 - 1
    return make_batched_solver(ocp, cfg, device="cpu"), x0


def test_spans_change_no_bit_and_the_counters_read_lock_step():
    solve, x0 = solver()
    plain = solve(x0)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = solve(x0)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    its = traced[3]
    counters = last_record().counters()
    assert counters["ip.lockstep_iters"] == int(its.max())
    assert counters["ip.lane_iters"] == int(its.sum())
    assert counters["ip.lane_slots"] == B * counters["ip.lockstep_iters"]
    summary = last_record().summary()
    trips = counters["ip.lockstep_iters"]
    assert summary["entry.solve"]["count"] == summary["ip.solve"]["count"] == 1
    for name in ("ip.newton", "k4.launch", "ip.line_search"):
        assert summary[name]["count"] == trips, name
    assert summary["ip.wait"]["count"] == trips + 1
    spans = last_record().spans
    parent = {name: spans[p][0] for name, _, _, p, _ in spans.values() if p is not None}
    assert parent["ip.solve"] == "entry.solve" and parent["k4.launch"] == "ip.newton"
    assert parent["ip.newton"] == parent["ip.line_search"] == parent["ip.wait"] == "ip.solve"


def test_without_a_profiler_the_ip_solve_records_nothing(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    solve, x0 = solver()
    record = last_record()
    before = (len(record.spans), dict(record.counts), len(record.kept))
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    solve(x0)
    assert last_record() is record
    assert (len(record.spans), dict(record.counts), len(record.kept)) == before
    assert getattr(profiling._local, "stack", None) in (None, [])
