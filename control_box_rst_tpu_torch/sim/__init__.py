from control_box_rst_tpu_torch.sim.benchmarks import (
    benchmark_increasing_n_masked,
    benchmark_increasing_n_open_loop,
    benchmark_varying_initial_state,
)
from control_box_rst_tpu_torch.sim.closed_loop import (
    ClosedLoopResult,
    run_closed_loop,
    run_open_loop,
)
from control_box_rst_tpu_torch.sim.observer import (
    KalmanCarry,
    NoObserver,
    SteadyStateKalmanObserver,
    zoh_discretize,
)
from control_box_rst_tpu_torch.sim.plant import GaussianNoise, SimulatedPlant

__all__ = [
    "SimulatedPlant", "GaussianNoise", "NoObserver", "SteadyStateKalmanObserver",
    "KalmanCarry", "zoh_discretize",
    "ClosedLoopResult", "run_closed_loop", "run_open_loop",
    "benchmark_varying_initial_state", "benchmark_increasing_n_open_loop",
    "benchmark_increasing_n_masked",
]
