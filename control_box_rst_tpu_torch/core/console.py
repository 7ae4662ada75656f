"""Console logging helpers.

Counterpart of the JAX package's ``core/console.py``: the PRINT_DEBUG /
INFO / WARNING / ERROR family with _ONCE and _COND variants, and the
process-global ``ok()`` / ``set_ok()`` cooperative-cancellation flag that
long-running host loops poll (``sim/realtime.py`` checks it between control
cycles).

The flag is sticky: ``comm.MasterServer.stop`` clears it and nothing here
sets it again, so whoever clears it (a test, a stop request) sets it back
with ``set_ok(True)`` before the next loop is to run.
"""
from __future__ import annotations

import logging
import threading

logger = logging.getLogger("control_box_rst_tpu_torch")

_once_seen: set = set()
_ok_flag = threading.Event()
_ok_flag.set()


def print_debug(msg: str) -> None:
    logger.debug(msg)


def print_info(msg: str) -> None:
    logger.info(msg)


def print_warning(msg: str) -> None:
    logger.warning(msg)


def print_error(msg: str) -> None:
    logger.error(msg)


def _once(key, fn, msg):
    if key not in _once_seen:
        _once_seen.add(key)
        fn(msg)


def print_warning_once(msg: str) -> None:
    _once(("W", msg), print_warning, msg)


def print_info_once(msg: str) -> None:
    _once(("I", msg), print_info, msg)


def print_error_cond(cond: bool, msg: str) -> None:
    if cond:
        print_error(msg)


def print_warning_cond(cond: bool, msg: str) -> None:
    if cond:
        print_warning(msg)


# -- cooperative cancellation ---------------------------------------------

def ok() -> bool:
    """True while tasks should keep running."""
    return _ok_flag.is_set()


def set_ok(value: bool) -> None:
    """Clearing requests cancellation of host loops (``sim/realtime.py``
    checks the flag between control cycles)."""
    if value:
        _ok_flag.set()
    else:
        _ok_flag.clear()
