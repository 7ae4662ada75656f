"""On the card: the control (the reference in float32 with TF32 products, in
the program's place) comes out not correct through the
same ``check.judge`` that passes the program. ``control.py`` runs the same at
a run's own number of units; here a few units keep the test short."""
import pytest

from perfbench import control

UNITS = {"di_h50.sweep": 20, "vdp_ms_h20.sweep": 4, "di_h50.rollouts": 4}


@pytest.mark.chip
@pytest.mark.parametrize("workload", sorted(UNITS))
def test_the_control_fails_the_check(workload, card):
    (row,) = control.readings(workload, [4100000001], UNITS[workload], device=card)
    assert row["correct"] is False, row
