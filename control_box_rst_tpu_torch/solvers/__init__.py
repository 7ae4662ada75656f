from control_box_rst_tpu_torch.solvers.ip import IPConfig, IPResult, ip_solve
from control_box_rst_tpu_torch.solvers.lm import LMConfig, LMResult, lm_solve
from control_box_rst_tpu_torch.solvers.sqp import (
    SQPConfig,
    SQPResult,
    SQPWarmStart,
    sqp_solve,
)
from control_box_rst_tpu_torch.solvers.stage_qp import (
    QPConfig,
    QPSolution,
    QPWarmStart,
    StageQP,
    dense_qp_oracle,
    solve_stage_qp,
)

__all__ = [
    "StageQP", "QPConfig", "QPWarmStart", "QPSolution", "solve_stage_qp",
    "dense_qp_oracle", "SQPConfig", "SQPResult", "SQPWarmStart", "sqp_solve",
    "LMConfig", "LMResult", "lm_solve", "IPConfig", "IPResult", "ip_solve",
]
