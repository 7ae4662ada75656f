"""The double integrator (corbo's SerialIntegratorSystem of order 2):
x1' = x2, x2' = u / T."""
import torch


def dynamics(params):
    T = float(params.get("time_constant", 1.0))
    return lambda x, u: torch.stack([x[..., 1], u[..., 0] / T], dim=-1)


def linear(params):
    """(A, B) of x' = A x + B u."""
    T = float(params.get("time_constant", 1.0))
    return [[0.0, 1.0], [0.0, 0.0]], [[0.0], [1.0 / T]]
