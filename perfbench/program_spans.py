"""The port's own spans and counters (srvp_tpu_torch/utils/trace.py), as
the metric readers read them. Under the benchmark tracing is on only in
the traced sub-window (the profiler's thread), so the totals are that
sub-window's; the loader's producer thread records the batches it makes
after a take there. A program without the registry, or a span or counter
that recorded nothing, reads as None."""


def snapshot():
    """The registry's snapshot, or None where the program has none."""
    try:
        from srvp_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def span(name):
    """{count, host_s, self_s, device_s} of the span `name`, or None."""
    snap = snapshot()
    if snap is None:
        return None
    s = snap["spans"].get(name)
    return s if s and s["count"] else None


def counter(name):
    snap = snapshot()
    return None if snap is None else snap["counters"].get(name)


def window_s(rec):
    """The traced sub-window's seconds, or None."""
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return rec.trace.window_s


def host_pct(rec, name):
    """100 x the host seconds of span `name` over the traced sub-window."""
    s, w = span(name), window_s(rec)
    if s is None or w is None:
        return None
    return 100.0 * s["host_s"] / w


def mean_host_ms(name):
    """1e3 x the host seconds of span `name` over its count."""
    s = span(name)
    return None if s is None else 1e3 * s["host_s"] / s["count"]


def device_pct(name, whole):
    """100 x the device seconds of span `name` over those of `whole`."""
    part, total = span(name), span(whole)
    if part is None or total is None or part["device_s"] is None \
            or not total["device_s"]:
        return None
    return 100.0 * part["device_s"] / total["device_s"]
