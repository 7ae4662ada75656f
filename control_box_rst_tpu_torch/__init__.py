"""control_box_rst_tpu_torch — the PyTorch / CUDA port of control_box_rst_tpu.

The package mirrors the JAX package's layout module by module
(``ops/smallmat.py`` here is the counterpart of ``ops/smallmat.py`` there) and
imports nothing of it: it depends on ``torch`` and ``numpy`` only.

Conventions of the port:
  - tensors are batch-first with the batch written out — every function takes
    ``[..., …]`` operands and broadcasts over the leading dims; there is no
    ``vmap`` on the hot path;
  - per-lane loops are Python loops with a ``done`` mask that freezes
    finished lanes;
  - every entry point takes an explicit ``device``; ``None`` means ``cuda``
    and raises when no card is present (``utils/precision.py``);
  - float32 is the production type, float64 is for tests and oracles, and
    TF32 is switched off.

Ported so far: the batched MPC solves by SQP of config 1 (LTI: the one-shot
path), config 2 (Van der Pol, multiple shooting) and config 3 (time-optimal
grid) (``parallel.make_batched_solver`` → ``solvers.sqp_solve`` →
``solvers.solve_stage_qp(backend='fused')`` → the hand-written CUDA kernels
of ``ops/cuda/admm_kernel.py``), the config-1 solve by Levenberg-Marquardt
(``parallel.make_batched_lm_solver`` → ``solvers.lm_solve`` → the
block-tridiagonal factor-and-solve kernels of ``ops/cuda/btridiag_kernel.py``),
the closed loop of config 5 (``parallel.make_batched_closed_loop`` →
``sim.run_closed_loop`` → ``control.PredictiveController``, warm-started SQP
or LM at every MPC step, against ``sim.SimulatedPlant``), and config 4: the
non-uniform time-optimal grid with a free dt per interval, open loop and
under MPC with grid adaptation (``ocp.adaptation``), every lane its own
active horizon through a per-lane stage mask; constrained OCPs and the
interior-point solver; every grid of the reference (the FD schemes and cost
integrations, uncompressed Hermite-Simpson with the midpoints in the stage
vector, move blocking) and block cyclic reduction; the LQR family
(``ops.matrix_eq``, ``control.classic``, ``control.dual_mode``, the
steady-state Kalman observer).
"""

__version__ = "0.1.0"

from control_box_rst_tpu_torch.utils import precision as _precision  # noqa: F401  (sets the TF32 policy)
