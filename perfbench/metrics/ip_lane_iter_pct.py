"""Useful share of the interior-point lock step over the traced solves, in
%: the port's ``ip.lane_iters`` (Σ of every lane's own IP iterations) over
its ``ip.lane_slots`` (lanes × the lock-step iterations of each solve,
which every lane pays)."""
from perfbench import program_spans


def read(record):
    got = program_spans.read()
    if got is None or not got[1].get("ip.lane_slots"):
        return None
    counters = got[1]
    return 100.0 * counters.get("ip.lane_iters", 0) / counters["ip.lane_slots"]
