"""Time / Duration value types.

Counterpart of the JAX package's ``core/timex.py`` (the reference's
ROS-style time API; ``Rate`` lives in ``native/``, backed by CLOCK_MONOTONIC
absolute deadlines). These are host-side types for experiment
orchestration.

Arithmetic: Time ± Duration → Time, Time − Time → Duration, Duration
scaled by floats, comparisons, now() / sleep_until().
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Union

from control_box_rst_tpu_torch.native import Rate, monotonic_time

__all__ = ["Time", "Duration", "Rate"]


@dataclass(frozen=True, order=True)
class Duration:
    """A signed time span in seconds."""

    seconds: float = 0.0

    @staticmethod
    def from_sec(s: float) -> "Duration":
        return Duration(float(s))

    def to_sec(self) -> float:
        return self.seconds

    def __add__(self, other: "Duration") -> "Duration":
        return Duration(self.seconds + other.seconds)

    def __sub__(self, other: "Duration") -> "Duration":
        return Duration(self.seconds - other.seconds)

    def __mul__(self, k: float) -> "Duration":
        return Duration(self.seconds * float(k))

    __rmul__ = __mul__

    def __truediv__(self, k: float) -> "Duration":
        return Duration(self.seconds / float(k))

    def __neg__(self) -> "Duration":
        return Duration(-self.seconds)

    def sleep(self) -> None:
        """Sleep this span."""
        if self.seconds > 0:
            _time.sleep(self.seconds)


@dataclass(frozen=True, order=True)
class Time:
    """A point on the monotonic clock, seconds since an arbitrary epoch."""

    seconds: float = 0.0

    @staticmethod
    def now() -> "Time":
        return Time(monotonic_time())

    @staticmethod
    def from_sec(s: float) -> "Time":
        return Time(float(s))

    def to_sec(self) -> float:
        return self.seconds

    def __add__(self, d: Duration) -> "Time":
        return Time(self.seconds + d.seconds)

    def __sub__(self, other: Union["Time", Duration]):
        if isinstance(other, Duration):
            return Time(self.seconds - other.seconds)
        return Duration(self.seconds - other.seconds)

    def sleep_until(self) -> None:
        """Sleep until this time point."""
        remaining = self.seconds - monotonic_time()
        if remaining > 0:
            _time.sleep(remaining)
