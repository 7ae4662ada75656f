"""Signal filters, one-step predictor and dead-time buffer, batch-first.

Counterpart of the JAX package's ``models/filters.py``:

  - ``MovingAverageFilter`` / ``MovingMedianFilter`` /
    ``MovingLeastSquaresFilter``: pure (carry, t, sample) → (carry, filtered)
    transitions over a fixed-size window; the carry holds the window of every
    lane, buffer [..., W] (newest last), and its valid count [...];
  - ``OneStepPredictor``: integrates the model over the pending control
    sequence, so a controller can solve from where the plant will be when its
    control takes effect;
  - ``TimeValueBuffer``: the actuation-delay buffer, u_hist [..., D, nu].

``init_carry`` takes the batch shape, ``dtype`` (``None`` means float32) and
``device`` (``None`` means the card, and raises when there is none).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from control_box_rst_tpu_torch.models.base import SystemDynamics
from control_box_rst_tpu_torch.ops.integrators import ExplicitIntegrator, make_integrator
from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


class FilterCarry(NamedTuple):
    buffer: torch.Tensor  # [..., W] the last W samples, newest last
    count: torch.Tensor   # [...] number of valid samples (≤ W), int32


def _zero_carry(window: int, batch_shape, dtype, device) -> FilterCarry:
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    batch_shape = tuple(batch_shape)
    return FilterCarry(
        torch.zeros(batch_shape + (window,), dtype=dtype, device=device),
        torch.zeros(batch_shape, dtype=torch.int32, device=device),
    )


def _push(carry: FilterCarry, value) -> FilterCarry:
    buf = carry.buffer
    v = torch.as_tensor(value, dtype=buf.dtype, device=buf.device)
    v = v.expand(buf.shape[:-1])
    buf = torch.cat([buf[..., 1:], v[..., None]], dim=-1)
    return FilterCarry(buffer=buf, count=torch.clamp(carry.count + 1, max=buf.shape[-1]))


def _valid_mask(carry: FilterCarry) -> torch.Tensor:
    W = carry.buffer.shape[-1]
    idx = torch.arange(W, device=carry.buffer.device)
    return idx >= (W - carry.count)[..., None]


@plain_dataclass
class MovingAverageFilter:
    """Mean over the last ``window`` samples."""

    window: int = 5

    def init_carry(self, batch_shape=(), dtype=None, device=None) -> FilterCarry:
        return _zero_carry(self.window, batch_shape, dtype, device)

    def __call__(self, carry: FilterCarry, t, value):
        carry = _push(carry, value)
        m = _valid_mask(carry)
        avg = (carry.buffer * m).sum(dim=-1) / torch.clamp(carry.count, min=1)
        return carry, avg


@plain_dataclass
class MovingMedianFilter:
    """Median over the last ``window`` samples."""

    window: int = 5

    def init_carry(self, batch_shape=(), dtype=None, device=None) -> FilterCarry:
        return _zero_carry(self.window, batch_shape, dtype, device)

    def __call__(self, carry: FilterCarry, t, value):
        carry = _push(carry, value)
        m = _valid_mask(carry)
        # masked median: invalid entries pushed to +inf, the middle of the
        # valid range taken lane by lane
        s = torch.sort(torch.where(m, carry.buffer, torch.full_like(carry.buffer, float("inf"))),
                       dim=-1).values
        n = carry.count.to(torch.int64)
        lo = torch.div(n - 1, 2, rounding_mode="floor")[..., None]
        hi = torch.div(n, 2, rounding_mode="floor")[..., None]
        med = 0.5 * (torch.take_along_dim(s, lo, dim=-1) + torch.take_along_dim(s, hi, dim=-1))
        return carry, med[..., 0]


@plain_dataclass
class MovingLeastSquaresFilter:
    """Fit a degree-``order`` polynomial to the window (least squares) and
    evaluate it at the newest sample; the raw sample until the window holds
    more than ``order`` of them."""

    window: int = 7
    order: int = 2

    def init_carry(self, batch_shape=(), dtype=None, device=None) -> FilterCarry:
        return _zero_carry(self.window, batch_shape, dtype, device)

    def __call__(self, carry: FilterCarry, t, value):
        carry = _push(carry, value)
        buf = carry.buffer
        m = _valid_mask(carry).to(buf.dtype)
        # abscissa 0..W-1; weighted LS with the mask as weights
        x = torch.arange(self.window, dtype=buf.dtype, device=buf.device)
        V = torch.stack([x ** p for p in range(self.order + 1)], dim=1)  # [W, o+1]
        Vm = V * m[..., :, None]
        eye = torch.eye(self.order + 1, dtype=buf.dtype, device=buf.device)
        A = Vm.mT @ V + 1e-9 * eye
        b = (Vm.mT @ buf[..., None])[..., 0]
        coef = torch.linalg.solve(A, b)
        fitted = (coef * V[-1]).sum(dim=-1)
        v = torch.as_tensor(value, dtype=buf.dtype, device=buf.device).expand(fitted.shape)
        return carry, torch.where(carry.count > self.order, fitted, v)


@plain_dataclass
class OneStepPredictor:
    """Predict x(t + dt) from x(t) and the pending control sequence."""

    system: SystemDynamics = None
    integrator: ExplicitIntegrator = None

    def __post_init__(self):
        if self.integrator is None:
            object.__setattr__(self, "integrator", make_integrator("rk4", 2))

    def predict(self, x0: torch.Tensor, u_seq: torch.Tensor, dt_seq: torch.Tensor) -> torch.Tensor:
        """Integrate x0 [..., nx] through the piecewise-constant sequence
        u_seq [..., n, nu] on the time steps dt_seq [..., n]."""
        x = x0
        for i in range(u_seq.shape[-2]):
            u, dtk = u_seq[..., i, :], dt_seq[..., i]
            if self.system.continuous_time:
                x = self.integrator.solve_ivp(self.system, x, u, dtk)
            else:
                x = torch.where((dtk > 0)[..., None], self.system(x, u), x)
        return x

    def predict_single(self, x0: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
        """One interval of length dt under the control u [..., nu]."""
        dt = torch.as_tensor(dt, dtype=x0.dtype, device=x0.device)
        return self.predict(x0, u[..., None, :], dt[None])


class DelayCarry(NamedTuple):
    u_hist: torch.Tensor  # [..., D, nu] most recent controls, newest last
    filled: torch.Tensor  # [...] int32 count of pushes


@plain_dataclass
class TimeValueBuffer:
    """Discrete dead-time buffer: the control applied now is the one
    commanded ``delay_steps`` intervals ago (a piecewise-constant signal on
    the fixed-dt closed loop)."""

    delay_steps: int = 1
    nu: int = 1

    def init_carry(self, u_init=None, batch_shape=(), dtype=None, device=None) -> DelayCarry:
        """The history filled with ``u_init`` [..., nu] (zeros by default)."""
        device, dtype = resolve_device(device), resolve_dtype(dtype)
        D = max(self.delay_steps, 1)
        hist = torch.zeros(tuple(batch_shape) + (D, self.nu), dtype=dtype, device=device)
        if u_init is not None:
            hist = hist + torch.as_tensor(u_init, dtype=dtype, device=device)[..., None, :]
        filled = torch.zeros(hist.shape[:-2], dtype=torch.int32, device=device)
        return DelayCarry(u_hist=hist, filled=filled)

    def push_pop(self, carry: DelayCarry, u_new: torch.Tensor):
        """Append the newly commanded u [..., nu]; return the delayed
        (applied) u."""
        if self.delay_steps == 0:
            return carry, u_new
        u_out = carry.u_hist[..., 0, :]
        hist = torch.cat([carry.u_hist[..., 1:, :], u_new[..., None, :]], dim=-2)
        return DelayCarry(u_hist=hist, filled=carry.filled + 1), u_out
