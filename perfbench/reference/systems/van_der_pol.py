"""The Van der Pol oscillator (corbo's VanDerPolOscillator):
x1' = x2, x2' = -a (x1^2 - 1) x2 - x1 + u."""
import torch


def dynamics(params):
    a = float(params.get("a", 1.0))
    return lambda x, u: torch.stack(
        [x[..., 1], -a * (x[..., 0] ** 2 - 1.0) * x[..., 1] - x[..., 0] + u[..., 0]], dim=-1)
