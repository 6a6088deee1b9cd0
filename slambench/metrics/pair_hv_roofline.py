"""pair_hv_roofline: the inertial pairs' H·v kernel against its roofline,
in %: the launches of ``gba_pair_hv`` inside the traced solve's span times
the least time of one launch at the card's published peaks (the problem's
``pair_hv_counts``: its bytes and operations, ``slambench/roofline.py``'s
peaks), over their device time summed by kernel name from the trace. None
where the trace holds no such kernel."""

from slambench import devtrace, roofline

KERNEL = "gba_pair_hv"


def read(rec):
    counts = getattr(rec["problem"], "pair_hv_counts", None)
    if rec["trace"] is None or counts is None:
        return None
    lo, hi = rec["solve_window"]
    ops = [op for op in devtrace.within(rec["trace"], lo, hi) if op[3] and KERNEL in op[0]]
    ns = sum(b - a for _, a, b, _ in ops)
    if not ops or ns <= 0:
        return None
    least, _ = roofline.least_seconds(counts(rec["shapes"]))
    return 100.0 * len(ops) * least / (ns * 1e-9)
