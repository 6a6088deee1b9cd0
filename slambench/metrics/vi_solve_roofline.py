"""vi_solve_roofline: the least time the inertial solve's work needs at the
card's published peaks (the problem's ``roofline_counts``: the bytes and
operations of the real observations, states and pairs, ``slambench/
roofline.py``'s peaks) over the time the card was busy inside the traced
solve's span, in %. None where the problem counts no such work."""

from slambench import devtrace, roofline


def read(rec):
    counts = getattr(rec["problem"], "roofline_counts", None)
    if rec["trace"] is None or counts is None:
        return None
    lo, hi = rec["solve_window"]
    busy = devtrace.busy_ns(devtrace.within(rec["trace"], lo, hi), lo, hi)
    if busy <= 0:
        return None
    least, _ = roofline.least_seconds(counts(rec["shapes"], rec["schedule"]))
    return 100.0 * least / (busy * 1e-9)
