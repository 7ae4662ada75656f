"""The port's closed-loop and benchmark tasks against the
JAX package's, float64 on the CPU.

- The closed-loop, ``benchmark_varying_x0`` and ``benchmark_increasing_n``
  dict configs of ``tests/test_config_master.py`` and
  ``tests/test_config_extended.py`` through both packages'
  ``run_experiment``: every recorded signal within 1e-6 (solve times:
  positive, the same count), output noise set to 0 where a config has some,
  ``T_steps`` cut to 6 where a config has more (their own: 40, 25 and 10).
The open-loop configs are in ``test_torch_master_open_loop.py`` and
``test_torch_master_constrained.py``, the CLI in ``test_torch_master_cli.py``.
"""
import jax  # noqa: F401 (the test configuration: CPU, x64)
import pytest
import torch

from torch_master_util import CLOSED_LOOP_TASKS, hold_task

torch.set_num_threads(1)


@pytest.mark.parametrize("name", CLOSED_LOOP_TASKS)
def test_tasks_match_jax(name):
    hold_task(name)
