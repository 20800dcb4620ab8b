"""Share of the traced sub-window in which no operation ran on the
device."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    busy = rec.trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / rec.trace.window_s)
