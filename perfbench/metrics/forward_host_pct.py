"""Share of the traced sub-window that the host spends in the training
step's forward (the program's span `srvp.train.forward`: zero_grad and
the ELBO's enqueue), in percent."""

from perfbench.program_spans import host_pct


def read(rec):
    return host_pct(rec, "srvp.train.forward")
