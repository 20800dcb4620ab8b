"""Batches already queued when the step loop takes one from the port's
loader, on average over the traced sub-window's takes: the program's
counters `srvp.data.ready` (the queue's size before each get) over
`srvp.data.takes`; 0 to the loader's prefetch (2)."""

from perfbench.program_spans import counter


def read(rec):
    takes, ready = counter("srvp.data.takes"), counter("srvp.data.ready")
    if not takes or ready is None:
        return None
    return ready / takes
