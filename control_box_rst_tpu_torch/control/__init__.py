from control_box_rst_tpu_torch.control.base import Controller, ControlOutput
from control_box_rst_tpu_torch.control.classic import (
    LqrController,
    PidCarry,
    PidController,
    SimpleStateController,
    StepResponseGenerator,
)
from control_box_rst_tpu_torch.control.dual_mode import DualModeCarry, DualModeController
from control_box_rst_tpu_torch.control.predictive import (
    MPCCarry,
    PredictiveController,
    find_nearest_state,
    shift_stage_rows,
    shift_warm_start,
)

__all__ = [
    "Controller", "ControlOutput", "PredictiveController", "MPCCarry",
    "find_nearest_state", "shift_warm_start", "shift_stage_rows",
    "LqrController", "PidController", "PidCarry", "SimpleStateController",
    "StepResponseGenerator", "DualModeController", "DualModeCarry",
]
