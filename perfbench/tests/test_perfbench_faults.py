"""A run of each cell, on the CPU at a tiny size (the look for a card
skipped), comes out correct, and comes out not correct when the timed path
is broken underneath in each way the cell can be: an answer altered where it
is produced, half of the batch left out (its answers copied from the other
half), half of the answers reported as not converged (the check's sample
left as it was), and, in the closed loops, a step that returns the plant's
state unchanged. One card a cell: there is no exchange between chips to leave out."""
import pytest
import torch

from control_box_rst_tpu_torch.control.predictive import PredictiveController
from control_box_rst_tpu_torch.parallel import sharded_solve
from control_box_rst_tpu_torch.sim.plant import SimulatedPlant
from perfbench import run
from perfbench.system import System

SMALL = {
    "di_h50.sweep": dict(batch=64, strata=[8, 8], warmup_units=1, check_per_unit=64),
    "vdp_ms_h20.sweep": dict(batch=16, strata=[4, 4], warmup_units=1, check_per_unit=16),
    "di_h50.rollouts": dict(batch=8, strata=[2, 4], warmup_units=1, check_per_unit=8, steps=4),
}


def correct(workload: str) -> bool:
    result, _ = run.run_cell(workload, 2**31 + 7, 0.5, False, device="cpu",
                             traffic_overrides=SMALL[workload], setup_clock=lambda: 0.0)
    return result["correct"]


def alter_solution(monkeypatch):
    real = sharded_solve.sqp_solve

    def altered(*args, **kw):
        res = real(*args, **kw)
        return res._replace(traj=res.traj.replace(U=res.traj.U + 1e-2))

    monkeypatch.setattr(sharded_solve, "sqp_solve", altered)


def alter_control(monkeypatch):
    real = PredictiveController.step

    def altered(self, carry, x, t, dt):
        carry, out = real(self, carry, x, t, dt)
        return carry, out._replace(u=out.u + 1e-2)

    monkeypatch.setattr(PredictiveController, "step", altered)


def half_batch(monkeypatch, method):
    real = getattr(System, method)

    def half(self, x0):
        h = x0.shape[0] // 2
        return tuple(torch.cat([a, a]) for a in real(self, x0[:h]))

    monkeypatch.setattr(System, method, half)


def unconverged(monkeypatch, method):
    """Every other lane's status (sweep) or step (closed loops) fails; the
    answers stay as they are, so only the failed share can tell."""
    real = getattr(System, method)

    def failing(self, *args):
        *answers, ok = real(self, *args)
        ok = ok.clone()
        ok.view(-1)[::2] = 0 if ok.dtype != torch.bool else False
        return (*answers, ok)

    monkeypatch.setattr(System, method, failing)


def frozen_plant(monkeypatch):
    monkeypatch.setattr(SimulatedPlant, "step", lambda self, x, u, dt, generator=None: x)


FAULTS = {
    "di_h50.sweep": {"altered": alter_solution, "half": lambda m: half_batch(m, "solve"),
                     "unconverged": lambda m: unconverged(m, "solve")},
    "vdp_ms_h20.sweep": {"altered": alter_solution, "half": lambda m: half_batch(m, "solve"),
                         "unconverged": lambda m: unconverged(m, "solve")},
    "di_h50.rollouts": {"altered": alter_control, "half": lambda m: half_batch(m, "rollout"),
                        "unconverged": lambda m: unconverged(m, "rollout"),
                        "frozen": frozen_plant},
}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_is_correct(workload):
    assert correct(workload)


@pytest.mark.parametrize("workload,fault", [(w, f) for w in sorted(FAULTS) for f in FAULTS[w]])
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[workload][fault](monkeypatch)
    assert not correct(workload)
