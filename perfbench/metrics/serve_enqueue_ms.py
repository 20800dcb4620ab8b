"""Host milliseconds a serving call spends enqueueing the exported
program (the program's span `srvp.serve.module`; the frames are not
waited for there), on average over the traced sub-window's calls."""

from perfbench.program_spans import mean_host_ms


def read(rec):
    return mean_host_ms("srvp.serve.module")
