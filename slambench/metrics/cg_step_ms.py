"""cg_step_ms: the card's milliseconds per CG step of the traced solve: the
device windows of the port's ``gba.cg_step`` spans (``optim/global_ba``,
H·v, the preconditioner, the dots and axpys; each from the span's entry to
its exit on the solve's stream), over the steps counted."""

from slambench import stages


def read(rec):
    ms = stages.device_ms(stages.in_solve(rec), "gba.cg_step")
    return sum(ms) / len(ms) if ms else None
