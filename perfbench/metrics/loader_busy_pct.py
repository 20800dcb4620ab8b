"""The loader's producer thread's utilisation: the mean host seconds of
its span `srvp.data.produce` (one batch made) times the steps of the
traced sub-window, over the sub-window, in percent. The producer makes
batches ahead of the steps, so its mean, not its total, is scaled to
them."""

from perfbench.program_spans import span, window_s


def read(rec):
    s, w = span("srvp.data.produce"), window_s(rec)
    if s is None or w is None or not rec.trace.units:
        return None
    return 100.0 * s["host_s"] / s["count"] * rec.trace.units / w
