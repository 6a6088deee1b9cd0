"""solve_roofline: the least time the solve's work needs at the card's
published peaks (``slambench/roofline.py``: the bytes and operations of the
real observations, bound by bytes at these shapes) over the time the card
was busy inside the traced solve's span, in %."""

from slambench import devtrace, roofline


def read(rec):
    if rec["trace"] is None:
        return None
    lo, hi = rec["solve_window"]
    busy = devtrace.busy_ns(devtrace.within(rec["trace"], lo, hi), lo, hi)
    if busy <= 0:
        return None
    least, _ = roofline.least_seconds(roofline.counts(rec["shapes"], rec["schedule"]))
    return 100.0 * least / (busy * 1e-9)
