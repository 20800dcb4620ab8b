"""The 95th percentile of the latency of every call in the window, from
the call to its uint8 frames on the host (numpy's linear interpolation
between order statistics)."""

import numpy as np


def read(rec):
    if rec.kind != "serve" or not rec.latencies_s:
        return None
    return 1e3 * float(np.percentile(rec.latencies_s, 95))
