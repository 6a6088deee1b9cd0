"""device_idle_pct: the share of a solve in which nothing runs on the card,
in %: one less the card's busy time (the union of its operations'
intervals) over the length of the same solve on the card's clock, from its
first operation to its last, both from the trace of one solve on the card
alone. The host's assembly at the solve's start counts as idle. The
profiler slows the host's launches, so a host-paced solve reads idler traced
than it runs untraced."""

from slambench import devtrace


def read(rec):
    if rec["trace"] is None:
        return None
    lo, hi = rec["solve_window"]
    busy = devtrace.busy_ns(rec["trace"].device_ops, lo, hi)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
