"""lm_outer_ms: the card's milliseconds per LM iteration of the traced
solve outside its CG steps: the device windows of the port's
``gba.linearize``, ``gba.precond`` and ``gba.accept`` spans summed, over
the LM iterations counted (``gba.linearize`` spans)."""

from slambench import stages


def read(rec):
    spans = stages.in_solve(rec)
    ms = stages.device_ms(spans, "gba.linearize", "gba.precond", "gba.accept")
    n = sum(s.name == "gba.linearize" for s in spans)
    return sum(ms) / n if ms and n else None
