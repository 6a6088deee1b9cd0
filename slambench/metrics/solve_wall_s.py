"""solve_wall_s: the seconds a whole solve takes on the host's clock — from
the start of ``build_full_problem`` to the host holding the poses,
landmarks and cost — over the untraced solves of a traced run's window,
their sum over their count (the benchmark's span ``SPAN_SOLVE`` of the
cell's problem). The same quantity as the end-to-end ``gba_solve_s``, read
where the host's drift from run to run is too wide for a bound."""


def read(rec):
    span = rec["problem"].SPAN_SOLVE
    d = [t1 - t0 for name, t0, t1 in rec["host_spans"] if name == span][rec["n_traced"]:]
    return sum(d) / len(d) if d else None
