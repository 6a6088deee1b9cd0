"""kernels_per_cg_step: the kernels the card ran inside the traced solve's
span (copies and sets left out), over the solve's LM iterations × CG steps:
the host's launches per step of the LM / CG loop. A count: it repeats
exactly while the program is unchanged."""

from slambench import devtrace


def read(rec):
    if rec["trace"] is None:
        return None
    lo, hi = rec["solve_window"]
    k = sum(1 for op in devtrace.within(rec["trace"], lo, hi) if op[3])
    s = rec["schedule"]
    return k / (s["lm_iterations"] * s["cg_steps"]) if k else None
