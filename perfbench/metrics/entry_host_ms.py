"""Host time of the entry and batching layer per traced batch, in ms: the
self time of the port's ``entry.solve`` spans (the batch's x0 to the
device, its initial guess, the call into SQP) over the traced units."""
from perfbench import program_spans


def read(record):
    got = program_spans.read()
    if got is None or not record.traced_units or "entry.solve" not in got[0]:
        return None
    return 1e3 * got[0]["entry.solve"]["self_s"] / record.traced_units
