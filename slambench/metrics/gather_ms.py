"""gather_ms: host milliseconds of the traced solve in
``slam/map_state.gather_observations`` and the octave lookup after it (the
port's ``gba.gather`` span, on the host clock), the mean over its spans."""

from slambench import stages


def read(rec):
    d = [s.end - s.start for s in stages.in_solve(rec) if s.name == "gba.gather"]
    return 1e3 * sum(d) / len(d) if d else None
