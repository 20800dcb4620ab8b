"""Share of the traced sub-window that the host spends in the training
step's optimizer (the program's span `srvp.train.optimizer`: Adam's
step and the schedule's), in percent."""

from perfbench.program_spans import host_pct


def read(rec):
    return host_pct(rec, "srvp.train.optimizer")
