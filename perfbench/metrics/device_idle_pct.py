"""Share of the traced window in which no operation ran on the device:
1 - (union of the device operations' intervals) / (wall time of the traced
units), in %."""


def read(record):
    if record.window_s <= 0:
        return None
    return 100.0 * (1.0 - record.busy_s / record.window_s)
