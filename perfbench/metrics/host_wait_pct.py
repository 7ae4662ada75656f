"""Share of the traced window in which the host waits for the device at the
SQP loop's exit test, in %: the duration of the port's ``sqp.wait`` spans
over the traced units' wall. A device-side gain lowers it; a host-side gain
raises it where the device then sets the pace."""
from perfbench import program_spans


def read(record):
    got = program_spans.read()
    if got is None or record.window_s <= 0 or "sqp.wait" not in got[0]:
        return None
    return 100.0 * got[0]["sqp.wait"]["total_s"] / record.window_s
