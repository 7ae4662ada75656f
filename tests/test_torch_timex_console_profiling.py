"""The port's ``core/timex.py``, ``core/console.py`` and
``utils/profiling.py`` on the CPU: the time-type case of
``tests/test_core_periphery.py:192``; the console helpers and the ok flag;
``PhaseTimer`` counts and totals (``block_on`` with CPU tensors and nests);
``device_trace`` writes a Chrome trace here."""
import json
import logging
import time

import pytest
import torch

from control_box_rst_tpu_torch.core import console
from control_box_rst_tpu_torch.utils.profiling import PhaseTimer, device_trace


def test_time_duration_types():
    from control_box_rst_tpu_torch.core.timex import Duration, Rate, Time

    d = Duration.from_sec(0.5)
    assert (d + d).to_sec() == 1.0
    assert (2 * d).to_sec() == 1.0
    assert (-d).to_sec() == -0.5
    t0 = Time.now()
    t1 = t0 + Duration.from_sec(2.0)
    assert isinstance(t1 - t0, Duration)
    assert abs((t1 - t0).to_sec() - 2.0) < 1e-9
    assert t1 > t0
    later = Time.now() + Duration.from_sec(0.05)
    later.sleep_until()
    assert Time.now() >= later
    assert (d / 2).to_sec() == 0.25 and (t1 - d).to_sec() == t1.to_sec() - 0.5
    assert Rate(0.01).period == 0.01


@pytest.fixture
def ok_restored():
    yield
    console.set_ok(True)


def test_console_helpers_and_ok_flag(caplog, ok_restored):
    assert console.logger.name == "control_box_rst_tpu_torch"
    with caplog.at_level(logging.DEBUG, logger="control_box_rst_tpu_torch"):
        console.print_info("i")
        console.print_warning_once("w-once")
        console.print_warning_once("w-once")
        console.print_error_cond(False, "never")
        console.print_error_cond(True, "e")
        console.print_warning_cond(True, "w")
        console.print_debug("d")
    msgs = [(r.levelname, r.getMessage()) for r in caplog.records]
    assert msgs == [("INFO", "i"), ("WARNING", "w-once"), ("ERROR", "e"),
                    ("WARNING", "w"), ("DEBUG", "d")]
    assert console.ok()
    console.set_ok(False)
    assert not console.ok()
    console.set_ok(True)
    assert console.ok()


def test_phase_timer_counts_and_totals():
    timer = PhaseTimer()
    x = torch.ones(3)
    for _ in range(3):
        with timer.phase("a", block_on=x):
            time.sleep(0.01)
    with timer.phase("b", block_on={"x": [x, (x,)], "n": 1}):
        pass
    s = timer.summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0.03
    assert s["a"]["mean_s"] == pytest.approx(s["a"]["total_s"] / 3)
    assert set(s) == {"a", "b"}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = sorted(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    with device_trace(str(tmp_path)):
        torch.zeros(1)
    assert len(list(tmp_path.iterdir())) == 2
