"""Useful share of lock step over the traced solves, in %: the port's
``sqp.lane_iters`` (Σ of every lane's own SQP iterations) over its
``sqp.lane_slots`` (lanes × the lock-step iterations of each solve, which
every lane pays)."""
from perfbench import program_spans


def read(record):
    got = program_spans.read()
    if got is None or not got[1].get("sqp.lane_slots"):
        return None
    counters = got[1]
    return 100.0 * counters.get("sqp.lane_iters", 0) / counters["sqp.lane_slots"]
