"""ctypes bindings for the native host runtime (``runtime.cpp``).

Counterpart of the JAX package's ``native/``: a drift-free ``Rate``, a
background-flushed binary ``SignalWriter``, ``set_realtime_priority`` and
``monotonic_time``, all on the host. The source is a copy of the reference's
``runtime.cpp``; the file format of ``SignalWriter`` is the same (magic
7557).

The library is compiled with ``g++`` at first use (never when this module is
imported) into ``build/native/libcbrst_runtime.so`` at the root of the
checkout, and rebuilt when the source is newer. Each process compiles to a
file of its own and moves it into place with ``os.replace``, so processes
that build at the same moment never load a half-written library. Without a
compiler, or when the build fails, the pure-Python fallbacks below run and
``native_available()`` says so.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
import time as _time

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "runtime.cpp"
_LIB = _SRC.parents[2] / "build" / "native" / "libcbrst_runtime.so"

_lib = None
_lock = threading.Lock()


def _build() -> bool:
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return True
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             "-o", str(tmp), str(_SRC), "-lpthread"],
            check=True, capture_output=True,
        )
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, _LIB)
    return True


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _build():
            return None
        lib = ctypes.CDLL(str(_LIB))
        lib.rate_create.restype = ctypes.c_void_p
        lib.rate_create.argtypes = [ctypes.c_double]
        lib.rate_sleep.restype = ctypes.c_double
        lib.rate_sleep.argtypes = [ctypes.c_void_p]
        lib.rate_reset.argtypes = [ctypes.c_void_p]
        lib.rate_overruns.restype = ctypes.c_longlong
        lib.rate_overruns.argtypes = [ctypes.c_void_p]
        lib.rate_destroy.argtypes = [ctypes.c_void_p]
        lib.monotonic_time.restype = ctypes.c_double
        lib.set_realtime_priority.restype = ctypes.c_int
        lib.set_realtime_priority.argtypes = [ctypes.c_int]
        lib.writer_create.restype = ctypes.c_void_p
        lib.writer_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.writer_push.restype = ctypes.c_int
        lib.writer_push.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_double)
        ]
        lib.writer_dropped.restype = ctypes.c_longlong
        lib.writer_dropped.argtypes = [ctypes.c_void_p]
        lib.writer_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    """True when the compiled library is in use (False: the pure-Python
    fallbacks run)."""
    return _load() is not None


class Rate:
    """Drift-free fixed-rate loop timer: CLOCK_MONOTONIC absolute deadlines
    (the fallback uses perf_counter + sleep)."""

    def __init__(self, period_s: float):
        self.period = float(period_s)
        lib = _load()
        if lib is not None:
            self._h = lib.rate_create(self.period)
            self._lib = lib
        else:
            self._h = None
            self._lib = None
            self._next = _time.perf_counter() + self.period
            self._overruns = 0

    def sleep(self) -> float:
        """Sleep to the next period boundary; returns slack seconds
        (negative on overrun)."""
        if self._lib is not None:
            return float(self._lib.rate_sleep(self._h))
        now = _time.perf_counter()
        slack = self._next - now
        if slack > 0:
            _time.sleep(slack)
            self._next += self.period
        else:
            self._overruns += 1
            self._next = now + self.period
        return slack

    def reset(self):
        if self._lib is not None:
            self._lib.rate_reset(self._h)
        else:
            self._next = _time.perf_counter() + self.period

    @property
    def overruns(self) -> int:
        if self._lib is not None:
            return int(self._lib.rate_overruns(self._h))
        return self._overruns

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.rate_destroy(self._h)
            self._h = None


def set_realtime_priority(priority: int = 10) -> bool:
    """Best-effort SCHED_FIFO escalation of the calling thread. Returns
    success; typically requires CAP_SYS_NICE."""
    lib = _load()
    if lib is None:
        return False
    return lib.set_realtime_priority(int(priority)) == 0


class SignalWriter:
    """High-rate binary signal logger that flushes in a background thread.

    File format: 3 float64 header (magic 7557, version, dim), then records
    of (t, values[dim]) float64. Read back with ``read_signal_log``."""

    def __init__(self, path: str, dim: int, capacity: int = 65536):
        lib = _load()
        self.dim = int(dim)
        self.path = path
        if lib is not None:
            self._h = lib.writer_create(
                str(path).encode(), self.dim, int(capacity)
            )
            if not self._h:
                raise OSError(f"cannot open {path}")
            self._lib = lib
            self._f = None
        else:
            self._lib = None
            self._f = open(path, "wb")
            np.array([7557.0, 1.0, float(dim)]).tofile(self._f)

    def push(self, t: float, values) -> bool:
        """Returns False if the record was dropped (ring full)."""
        v = np.ascontiguousarray(values, dtype=np.float64)
        if self._lib is not None:
            ptr = v.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            return self._lib.writer_push(self._h, float(t), ptr) == 0
        np.concatenate([[t], v]).tofile(self._f)
        return True

    @property
    def dropped(self) -> int:
        if self._lib is not None and self._h:
            return int(self._lib.writer_dropped(self._h))
        return getattr(self, "_dropped_final", 0)

    def close(self):
        if self._lib is not None and self._h:
            self._dropped_final = int(self._lib.writer_dropped(self._h))
            self._lib.writer_close(self._h)
            self._h = None
        elif self._f:
            self._f.close()
            self._f = None


def read_signal_log(path: str):
    """Read a SignalWriter file → (times [T], values [T, dim])."""
    raw = np.fromfile(path, dtype=np.float64)
    magic, version, dim = raw[0], raw[1], int(raw[2])
    if magic != 7557.0:
        raise ValueError(f"{path}: not a cbrst signal log")
    body = raw[3:]
    n = len(body) // (dim + 1)
    body = body[: n * (dim + 1)].reshape(n, dim + 1)
    return body[:, 0], body[:, 1:]


def monotonic_time() -> float:
    lib = _load()
    if lib is not None:
        return float(lib.monotonic_time())
    return _time.perf_counter()
