"""The port's own kernels (csrc/*.cu: rollouts 1-3 against their
operations bound, pools and upsamples 4-7 against their bytes bound) in
the traced sub-window: the sum of their least times at the cell's shapes
(the frozen yardstick, per unit, times the units traced) over the sum of
their measured device times, in percent."""

from perfbench.yardstick.families import is_own


def read(rec):
    if rec.trace is None or not rec.bound_s_per_unit:
        return None
    own = sum(b - a for n, a, b in rec.trace.kernels() if is_own(n)) * 1e-6
    if own <= 0:
        return None
    return 100.0 * rec.bound_s_per_unit * rec.trace.units / own
