"""Share of the traced sub-window that the step loop waits on the port's
loader: the host seconds of the program's span `srvp.data.wait` (around
the loader queue's get) over the sub-window, in percent."""

from perfbench.program_spans import host_pct


def read(rec):
    return host_pct(rec, "srvp.data.wait")
