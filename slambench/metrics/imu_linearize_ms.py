"""imu_linearize_ms: the card's milliseconds per LM iteration of the traced
solve in the inertial pairs' linearization: the device windows of the
port's ``gba.imu_linearize`` spans (``optim/global_inertial_ba``: each
pair's 15 residuals and their 15 × 30 Jacobian by forward-mode autodiff),
over the spans counted. A window runs from the span's first operation on
the card to its last; the host's launches of ``vmap(jacfwd)``'s many small
kernels pace it, so it moves the solve's wall time (read in this cell as
``solve_wall_s.launch_paced``) far more than the card's busy time. None
where the program logs no such span."""

from slambench import stages


def read(rec):
    ms = stages.device_ms(stages.in_solve(rec), "gba.imu_linearize")
    return sum(ms) / len(ms) if ms else None
