"""K1's share of its roofline over the traced units, in %:

    sum over K1 launches of max(ops / peak FLOP/s, bytes / peak B/s)
    ----------------------------------------------------------------
                  sum over K1 launches of device time

with the operations and bytes of each launch from the frozen counts and the
launch's shapes alone (``counts/k1.py: launch_work``) and the published
peaks (``counts/peaks.py``). On the cells' shapes the operations bound it."""
from perfbench.counts import k1, peaks


def read(record):
    if not record.k1_s:
        return None
    if len(record.k1_s) != len(record.k1_shapes):
        raise ValueError(f"{len(record.k1_s)} K1 kernels traced, "
                         f"{len(record.k1_shapes)} launches recorded")
    least = 0.0
    for s in record.k1_shapes:
        ops, nbytes = k1.launch_work(**s)
        least += max(ops / peaks.PEAK_FP32_PER_S, nbytes / peaks.PEAK_BYTES_PER_S)
    return 100.0 * least / sum(record.k1_s)
