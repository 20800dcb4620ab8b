"""Device kernels launched per unit of the traced sub-window (for serving,
per artifact call), from the profiler's device events; copies and memsets
are not counted."""


def read(rec):
    if rec.trace is None or not rec.trace.units:
        return None
    n = len(rec.trace.kernels())
    return n / rec.trace.units if n else None
