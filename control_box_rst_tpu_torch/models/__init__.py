from control_box_rst_tpu_torch.models.base import SystemDynamics
from control_box_rst_tpu_torch.models.benchmark import (
    DoubleIntegratorContinuous,
    SerialIntegratorSystem,
    VanDerPolOscillator,
)

__all__ = ["SystemDynamics", "SerialIntegratorSystem", "DoubleIntegratorContinuous",
           "VanDerPolOscillator"]
