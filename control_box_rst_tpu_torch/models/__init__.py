from control_box_rst_tpu_torch.models.base import (
    FunctionalDynamics,
    SystemDynamics,
    check_dimensions,
)
from control_box_rst_tpu_torch.models.benchmark import (
    ALL_BENCHMARK_SYSTEMS,
    ArtsteinsCircle,
    CartPole,
    DoubleIntegratorContinuous,
    DoubleIntegratorDiscreteTime,
    DuffingOscillator,
    FreeSpaceRocket,
    LinearStateSpaceModel,
    MasslessPendulum,
    ParallelIntegratorSystem,
    SerialIntegratorSystem,
    SimplePendulum,
    ToyExample,
    VanDerPolOscillator,
)
from control_box_rst_tpu_torch.models.filters import (
    DelayCarry,
    FilterCarry,
    MovingAverageFilter,
    MovingLeastSquaresFilter,
    MovingMedianFilter,
    OneStepPredictor,
    TimeValueBuffer,
)
from control_box_rst_tpu_torch.models.outputs import (
    FirstStateSystemOutput,
    FullStateSystemOutput,
    LinearStateSystemOutput,
    SystemOutput,
)

__all__ = [
    "SystemDynamics", "FunctionalDynamics", "check_dimensions",
    "SerialIntegratorSystem", "ParallelIntegratorSystem", "LinearStateSpaceModel",
    "DoubleIntegratorDiscreteTime", "DoubleIntegratorContinuous", "VanDerPolOscillator",
    "DuffingOscillator", "FreeSpaceRocket", "SimplePendulum", "MasslessPendulum",
    "CartPole", "ToyExample", "ArtsteinsCircle", "ALL_BENCHMARK_SYSTEMS",
    "MovingAverageFilter", "MovingMedianFilter", "MovingLeastSquaresFilter",
    "FilterCarry", "OneStepPredictor", "TimeValueBuffer", "DelayCarry",
    "SystemOutput", "FullStateSystemOutput", "FirstStateSystemOutput",
    "LinearStateSystemOutput",
]
