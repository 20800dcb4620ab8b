"""Share of the traced sub-window that the host spends in the training
step's backward (the program's span `srvp.train.backward`: the backward
and the gradients' average over the ranks), in percent."""

from perfbench.program_spans import host_pct


def read(rec):
    return host_pct(rec, "srvp.train.backward")
