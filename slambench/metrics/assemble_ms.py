"""assemble_ms: host milliseconds a solve spends building its problem —
``slam/ba_assembly.build_full_problem`` and ``optim/global_ba.PoseSegments``,
synchronized — the mean over the window's solves (the benchmark's own span
``gba.assemble`` on the host clock)."""


def read(rec):
    d = [t1 - t0 for name, t0, t1 in rec["host_spans"] if name == "gba.assemble"]
    return 1e3 * sum(d) / len(d) if d else None
