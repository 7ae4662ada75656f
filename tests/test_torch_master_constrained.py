"""The open-loop dict configs of ``tests/test_config_extended.py`` with
constraint rows and soft bounds (the terminal ball, a general row, through
the plain ADMM; the gain-scheduled minimum-time cost with L1 soft state
bounds and a final-state cost) through both packages' ``run_experiment``,
float64 on the CPU: every recorded signal within 1e-6.
"""
import jax  # noqa: F401 (the test configuration: CPU, x64)
import pytest
import torch

from torch_master_util import hold_task

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["ext_terminal_ball", "ext_gain_scheduled"])
def test_constrained_open_loop_tasks_match_jax(name):
    hold_task(name)
