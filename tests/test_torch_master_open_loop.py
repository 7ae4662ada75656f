"""The open-loop dict configs of ``tests/test_config_master.py`` (the
time-optimal grid with one tied dt, the least-squares minimum time on the
non-uniform grid) through both packages' ``run_experiment``, float64 on the
CPU: every recorded signal within 1e-6.
"""
import jax  # noqa: F401 (the test configuration: CPU, x64)
import pytest
import torch

from torch_master_util import hold_task

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["master_time_optimal", "master_minimum_time_lsq"])
def test_open_loop_tasks_match_jax(name):
    hold_task(name)
