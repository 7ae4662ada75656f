from control_box_rst_tpu_torch.models.base import FunctionalDynamics, SystemDynamics
from control_box_rst_tpu_torch.models.benchmark import (
    DoubleIntegratorContinuous,
    SerialIntegratorSystem,
    VanDerPolOscillator,
)
from control_box_rst_tpu_torch.models.filters import OneStepPredictor

__all__ = ["SystemDynamics", "FunctionalDynamics", "SerialIntegratorSystem", "DoubleIntegratorContinuous",
           "VanDerPolOscillator", "OneStepPredictor"]
