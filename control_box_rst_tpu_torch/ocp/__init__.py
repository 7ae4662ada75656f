from control_box_rst_tpu_torch.ocp.costs import (
    CompositeCost,
    QuadraticFinalStateCost,
    QuadraticFormCost,
    StageCost,
)
from control_box_rst_tpu_torch.ocp.grids import Grid, finite_differences_grid
from control_box_rst_tpu_torch.ocp.problem import (
    BoundaryConditions,
    Bounds,
    References,
    Trajectory,
)
from control_box_rst_tpu_torch.ocp.transcribe import TranscribedOCP, transcribe

__all__ = [
    "StageCost", "QuadraticFormCost", "QuadraticFinalStateCost", "CompositeCost",
    "Grid", "finite_differences_grid",
    "Trajectory", "Bounds", "References", "BoundaryConditions",
    "TranscribedOCP", "transcribe",
]
