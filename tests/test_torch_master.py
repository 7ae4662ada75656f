"""The port's ``run_experiment`` on the example YAMLs against the JAX
package's, float64 on the CPU.

Configs 1, 2, 3, 5 and 6 through both packages' ``run_experiment``: the
recorded signal names one for one; the applied controls, plant states,
plant outputs and observed states (config 3, an open loop: the planned
controls and states and the plant rolled along them) within 1e-6; and the
port's run within 1e-6 of the golden of ``tools/master_golden.py`` (the JAX
package's own float64 run of the whole example,
``tests/golden/torch_master_examples.npz``) over the steps it runs, with the
same SQP iteration count at every step. Config 5 runs with its output noise
set to 0 (the two packages draw from different generators). Cut for the
time of an eager float64 run on the CPU (``torch_master_util.EXAMPLES``):
``T_steps`` 3 for configs 1, 2, 5 and 6 (their YAMLs: 70, 60, 60, 40);
config 3 runs whole. Config 4 has a file of its own
(``test_torch_master_config4.py``); the tasks and the CLI are in the other
``test_torch_master_*.py`` files.
"""
import jax  # noqa: F401 (the test configuration: CPU, x64)
import pytest
import torch

from torch_master_util import example, hold_example

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config5_noise0", "config6"])
def test_example_matches_jax_and_the_golden(name):
    _, rt = hold_example(name, example(name))
    if name == "config5_noise0":
        assert "controller/local_active" in list(rt.names())
