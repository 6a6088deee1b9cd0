"""The port's own spans inside the traced solve, for the readers of the
per-layer metrics that split a solve by stage.

While a ``torch.profiler`` session runs, the port logs its spans
(``orb_slam3_rgbl_tpu_torch.utils.profiling.span_log``): ``gba.build`` ⊃
``gba.gather`` and ``gba.segments`` around the assembly, ``gba.lm`` ⊃
``gba.linearize``, ``gba.precond``, one ``gba.cg_step`` a CG step,
``gba.accept`` and ``gba.final`` inside ``optim/global_ba``; each with its
host window on ``time.perf_counter()`` (the clock of the benchmark's own
spans) and, on the card, its device window in ms. A program that keeps no
such log gives nothing, and the readers then return None.
"""

from __future__ import annotations

from slambench.program import SPAN_SOLVE


def in_solve(rec) -> list:
    """The logged spans whose host start falls inside the run's first
    ``gba.solve`` span (the solve traced on the card alone); [] where the
    program keeps no log."""
    try:
        from orb_slam3_rgbl_tpu_torch.utils.profiling import span_log
    except ImportError:
        return []
    solves = [(t0, t1) for name, t0, t1 in rec["host_spans"] if name == SPAN_SOLVE]
    if not solves:
        return []
    lo, hi = solves[0]
    return [s for s in span_log() if lo <= s.start <= hi]


def device_ms(spans: list, *names: str) -> list:
    """The device windows (ms) of the spans named ``names``; none off the card."""
    return [s.device_ms for s in spans if s.name in names and s.device_ms is not None]

