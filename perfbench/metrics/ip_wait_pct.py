"""Share of the traced window in which the host waits for the device at the
interior-point loop's test, in %: the duration of the port's ``ip.wait``
spans over the traced units' wall. Where eager device work sets the pace
the host spends much of the window here; a device-side gain lowers it."""
from perfbench import program_spans


def read(record):
    got = program_spans.read()
    if got is None or record.window_s <= 0 or "ip.wait" not in got[0]:
        return None
    return 100.0 * got[0]["ip.wait"]["total_s"] / record.window_s
