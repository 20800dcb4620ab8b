"""Host milliseconds a serving call spends on its inputs (the program's
span `srvp.serve.input`: the frames' and the seed's copies to the
device), on average over the traced sub-window's calls."""

from perfbench.program_spans import mean_host_ms


def read(rec):
    return mean_host_ms("srvp.serve.input")
