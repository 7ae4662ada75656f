"""Device kernels launched per lock-step interior-point iteration in the
traced batches: the profiler's kernel count over the port's
``ip.lockstep_iters`` counter of the same traced units."""
from perfbench import program_spans


def read(record):
    got = program_spans.read()
    if got is None or not record.n_kernels or not got[1].get("ip.lockstep_iters"):
        return None
    return record.n_kernels / got[1]["ip.lockstep_iters"]
