"""ATen elementwise and reduction kernels' share of the device's busy time
in the traced sub-window, by the frozen family classifier."""

from perfbench.yardstick.families import family

FAMILIES = ("elementwise (ATen)", "reduction (ATen)")


def read(rec):
    if rec.trace is None:
        return None
    by_name = rec.trace.by_name()
    total = sum(by_name.values())
    if total <= 0:
        return None
    part = sum(s for n, s in by_name.items() if family(n) in FAMILIES)
    return 100.0 * part / total
