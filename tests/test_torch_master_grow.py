"""The grow-on-infeasibility closed loop of ``tests/test_config_extended.py``
(a 30-interval fixed-dt horizon pinned at the goal, an active horizon that
starts at 8 and grows while a solve is infeasible) through both packages'
``run_experiment``, float64 on the CPU: every recorded signal within 1e-6.

Cut to ``T_steps`` 1 of its 25: one step runs 30 SQP iterations of 200
ADMM iterations on the masked horizon, ~50 s of eager float64 here. The
growth itself is held by ``tests/test_torch_adaptation.py``; here the
loader's adaptation, initial horizon and unshifted warm start.
"""
import jax  # noqa: F401 (the test configuration: CPU, x64)
import torch

from torch_master_util import hold_task

torch.set_num_threads(1)


def test_grow_on_infeasibility_matches_jax():
    _, rt = hold_task("ext_grow_on_infeasibility")
    assert rt.get("controller/n_active")["values"].tolist() == [8]
