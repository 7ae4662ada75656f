"""Lock-step interior-point iterations per traced solve batch: the port's
``ip.lockstep_iters`` counter (one a trip of the IP loop, which every lane
of the batch waits out) over the traced units."""
from perfbench import program_spans


def read(record):
    got = program_spans.read()
    if got is None or not record.traced_units or not got[1].get("ip.lockstep_iters"):
        return None
    return got[1]["ip.lockstep_iters"] / record.traced_units
