from control_box_rst_tpu_torch.ocp.constraints import (
    FunctionalStageConstraint,
    StageConstraint,
    TerminalBall,
    TerminalConstraint,
    TerminalEquality,
    TerminalPartialEquality,
    terminal_ball_from_cost,
    terminal_equality,
    terminal_partial_equality,
)
from control_box_rst_tpu_torch.ocp.costs import (
    CompositeCost,
    L1SoftConstraintCost,
    MinimumTime,
    MinimumTimeRegularized,
    MinTimeQuadratic,
    MinTimeQuadraticControls,
    MinTimeQuadraticGainScheduled,
    MinTimeQuadraticStates,
    QuadraticControlCost,
    QuadraticFinalStateCost,
    QuadraticFormCost,
    QuadraticStateCost,
    StageCost,
    riccati_terminal_cost,
)
from control_box_rst_tpu_torch.ocp.preprocessor import (
    PreprocessedStageConstraint,
    PreprocessedStageCost,
    StagePreprocessor,
)
from control_box_rst_tpu_torch.ocp.grids import (
    Grid,
    finite_differences_grid,
    finite_differences_variable_grid,
    hermite_simpson_uncompressed_grid,
    move_blocking_grid,
    multiple_shooting_grid,
    multiple_shooting_variable_grid,
    non_uniform_fd_variable_grid,
    non_uniform_multiple_shooting_variable_grid,
)
from control_box_rst_tpu_torch.ocp.problem import (
    BoundaryConditions,
    Bounds,
    References,
    Trajectory,
)
from control_box_rst_tpu_torch.ocp.transcribe import TranscribedOCP, transcribe
from control_box_rst_tpu_torch.ocp.adaptation import (
    GridAdaptation,
    GrowOnInfeasibility,
    RedundantControls,
    SimpleShrinkingHorizon,
    TimeBasedAggressiveEstimate,
    TimeBasedSingleStep,
    resample_W,
    stage_mask_from_n,
)

__all__ = [
    "StageCost", "QuadraticFormCost", "QuadraticFinalStateCost", "CompositeCost",
    "MinimumTime", "QuadraticStateCost", "QuadraticControlCost", "MinimumTimeRegularized",
    "MinTimeQuadratic", "MinTimeQuadraticControls", "MinTimeQuadraticStates",
    "MinTimeQuadraticGainScheduled", "L1SoftConstraintCost", "riccati_terminal_cost",
    "StageConstraint", "FunctionalStageConstraint", "TerminalConstraint", "TerminalBall",
    "terminal_ball_from_cost", "TerminalEquality", "terminal_equality",
    "TerminalPartialEquality", "terminal_partial_equality",
    "StagePreprocessor", "PreprocessedStageCost", "PreprocessedStageConstraint",
    "Grid", "finite_differences_grid", "finite_differences_variable_grid",
    "hermite_simpson_uncompressed_grid", "move_blocking_grid",
    "multiple_shooting_grid", "multiple_shooting_variable_grid",
    "non_uniform_fd_variable_grid", "non_uniform_multiple_shooting_variable_grid",
    "Trajectory", "Bounds", "References", "BoundaryConditions",
    "TranscribedOCP", "transcribe",
    "GridAdaptation", "TimeBasedSingleStep", "TimeBasedAggressiveEstimate",
    "SimpleShrinkingHorizon", "GrowOnInfeasibility", "RedundantControls",
    "resample_W", "stage_mask_from_n",
]
