"""Config 4's YAML (``examples/config4_nonuniform_time_optimal.yaml``:
non-uniform time-optimal grid, RedundantControls adaptation, the planned
sequence applied in 8 substeps) through both packages' ``run_experiment``,
float64 on the CPU: the signal names one for one, the applied controls,
plant states, outputs and observed states within 1e-6, the port within 1e-6
of the golden's first step (``tests/golden/torch_master_examples.npz``), the
same SQP iterations.

Cut to ``T_steps`` 1 of the YAML's 30: one step runs 25 SQP iterations of
500 ADMM iterations each, ~60 s of eager float64 here (the whole run is the
card's, in ``chip_smoke.py``'s master phase).
"""
import jax  # noqa: F401 (the test configuration: CPU, x64)
import torch

from torch_master_util import example, hold_example

torch.set_num_threads(1)


def test_config4_matches_jax_and_the_golden():
    hold_example("config4", example("config4"))
