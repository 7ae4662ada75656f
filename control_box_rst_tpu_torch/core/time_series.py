"""Time series container with interpolation.

Counterpart of the JAX package's ``core/time_series.py``: a time-stamped
value matrix (times [T], values [T, d]) with zero-order-hold or linear
interpolation, hold or linear extrapolation, and a stacked sequence of such
series. ``value_at`` takes one time or a tensor of times [...] and returns
[..., d].
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from control_box_rst_tpu_torch.utils.tree import plain_dataclass


@plain_dataclass
class TimeSeries:
    times: torch.Tensor   # [T]
    values: torch.Tensor  # [T, d]

    @property
    def n(self) -> int:
        return self.times.shape[0]

    @property
    def dim(self) -> int:
        return self.values.shape[-1]

    @staticmethod
    def from_arrays(times, values) -> "TimeSeries":
        """From arrays or tensors; numbers and numpy arrays become float64
        tensors on the host."""
        as_t = lambda a: a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a, dtype=np.float64))
        times, values = as_t(times), as_t(values)
        if values.dim() == 1:
            values = values[:, None]
        return TimeSeries(times=times, values=values)

    @staticmethod
    def from_scan(ts, values) -> "TimeSeries":
        return TimeSeries.from_arrays(ts, values)

    def value_at(self, t, interpolation: str = "linear",
                 extrapolation: str = "hold") -> torch.Tensor:
        """Sample at time(s) t. interpolation: 'zero_order_hold' | 'linear';
        extrapolation: 'hold' | 'linear' (from the last interval)."""
        times, vals = self.times, self.values
        T = self.n
        t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
        idx = torch.clamp(torch.searchsorted(times, t.reshape(-1), right=True) - 1, 0, T - 1)
        idx = idx.reshape(t.shape)
        idx1 = torch.clamp(idx + 1, max=T - 1)
        t0, t1 = times[idx], times[idx1]
        v0, v1 = vals[idx], vals[idx1]
        if interpolation == "zero_order_hold":
            inner = v0
        else:
            step = t1 > t0
            w = torch.where(step, (t - t0) / torch.where(step, t1 - t0, torch.ones_like(t0)),
                            torch.zeros_like(t0))
            inner = v0 + w[..., None] * (v1 - v0)
        below = (t < times[0])[..., None]
        above = (t > times[-1])[..., None]
        if extrapolation == "hold":
            return torch.where(below, vals[0], torch.where(above, vals[-1], inner))
        # linear extrapolation from the last interval
        if T > 1:
            tm1, tm0 = times[-2], times[-1]
            gap = torch.where(tm0 > tm1, tm0 - tm1, torch.ones_like(tm0))
            slope = (vals[-1] - vals[-2]) / gap
        else:
            tm0, slope = times[-1], torch.zeros_like(vals[-1])
        return torch.where(
            below, vals[0],
            torch.where(above, vals[-1] + (t - tm0)[..., None] * slope, inner),
        )

    def normalized_time(self) -> "TimeSeries":
        """Shift so the times start at 0."""
        return self.replace(times=self.times - self.times[0])

    def shifted(self, dt) -> "TimeSeries":
        return self.replace(times=self.times + dt)

    def sliced(self, start: int, stop: int) -> "TimeSeries":
        return TimeSeries(times=self.times[start:stop], values=self.values[start:stop])

    def mean(self) -> torch.Tensor:
        return self.values.mean(dim=0)

    def final(self) -> torch.Tensor:
        return self.values[-1]

    def to_numpy(self):
        return self.times.detach().cpu().numpy(), self.values.detach().cpu().numpy()


@plain_dataclass
class TimeSeriesSequence:
    """Ordered collection of time series of equal length and dim (stacked)."""

    times: torch.Tensor   # [S, T]
    values: torch.Tensor  # [S, T, d]

    @property
    def n_series(self) -> int:
        return self.times.shape[0]

    def series(self, i: int) -> TimeSeries:
        return TimeSeries(times=self.times[i], values=self.values[i])

    @staticmethod
    def stack(series: Sequence[TimeSeries]) -> "TimeSeriesSequence":
        return TimeSeriesSequence(
            times=torch.stack([s.times for s in series]),
            values=torch.stack([s.values for s in series]),
        )
