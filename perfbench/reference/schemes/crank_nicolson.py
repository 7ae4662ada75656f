"""Crank-Nicolson finite differences with the control held over the interval,
0.5 (f(x_k, u_k) + f(x_{k+1}, u_k)) = (x_{k+1} - x_k) / dt, solved exactly
for a linear system: (I - dt/2 A) x_{k+1} = (I + dt/2 A) x_k + dt B u_k."""
import torch


def step(system, params, grid, dtype, device):
    A, B = (torch.tensor(m, dtype=dtype, device=device) for m in system.linear(params))
    eye = torch.eye(A.shape[0], dtype=dtype, device=device)
    dt = float(grid["dt"])
    lhs_inv = torch.linalg.inv(eye - 0.5 * dt * A)
    Ad, Bd = lhs_inv @ (eye + 0.5 * dt * A), lhs_inv @ (dt * B)
    return lambda x, u: x @ Ad.T + u @ Bd.T
