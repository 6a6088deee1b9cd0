"""The least work a whole-map solve needs, from its shapes alone, and the
card's published peaks.

The count is the algorithm's, not the program's: the real keyframes ``n_kf``,
landmarks ``n_lm`` and observations ``n_obs`` (padding and masked slots are
the program's waste and are not counted), float32 values and 4-byte indices,
each stage's inputs read once and its outputs written once:

* a linearization (one an LM iteration) reads each observation (keyframe
  index, u, v, u_R, 1/σ²: 20 bytes), the poses (7 values) and landmarks (3),
  and writes each observation's residual, pose and landmark Jacobians and
  weight (3 + 18 + 9 + 1 values);
* the gradient and the block-Jacobi preconditioner (one an LM iteration)
  read those 31 values an observation and write the gradient (6 a pose, 3 a
  landmark) and the damped diagonal blocks' inverses (36 a pose, 9 a
  landmark);
* a CG step reads each observation's Jacobians, weight and keyframe index
  (28 values + 4 bytes), the search direction, the iterate, the residual,
  the damping diagonal (one vector each, 6 a pose and 3 a landmark) and the
  preconditioner, and writes the iterate, the residual and the direction;
* the step's acceptance (one an LM iteration) and the final cost read each
  observation, the poses and landmarks (and the step), the acceptance writes
  the poses and landmarks.

Operations count the multiply-adds of the per-observation products (as 2
each) and the vector work of a CG step; the small per-observation
arithmetic of a projection is counted at 30 operations.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet, dense, at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_FP32_FLOPS = 67e12         # float32 outside the tensor cores

F = 4       # bytes of a float32
IDX = 4     # bytes of an index


def counts(shapes: dict, schedule: dict) -> dict:
    """{'bytes', 'flops'} of one solve."""
    n, K, M = shapes["n_obs"], shapes["n_kf"], shapes["n_lm"]
    its, cg = schedule["lm_iterations"], schedule["cg_steps"]
    obs_in = n * (IDX + 4 * F)                    # keyframe index, u, v, u_R, 1/σ²
    state = (7 * K + 3 * M) * F                   # poses and landmarks
    vec = (6 * K + 3 * M) * F                     # one vector of the unknowns
    precond = (36 * K + 9 * M) * F

    lin_bytes = obs_in + state + n * 31 * F
    lin_flops = n * (30 + 2 * (9 + 54 + 27))      # projection, R·X, Jproj·[I|−p×], Jproj·R
    grad_bytes = n * 31 * F + vec + precond
    grad_flops = n * 2 * (18 + 9 + 108 + 27) + K * 2 * 216 + M * 2 * 27
    cg_bytes = n * (28 * F + IDX) + 4 * vec + precond + 3 * vec
    cg_flops = n * (2 * 27 + 3 + 2 * 27) + K * (72 + 6 * 12) + M * (18 + 3 * 12)
    acc_bytes = obs_in + state + vec + state
    acc_flops = n * (30 + 2 * 9)
    final_bytes = obs_in + state
    return {
        "bytes": its * (lin_bytes + grad_bytes + cg * cg_bytes + acc_bytes) + final_bytes,
        "flops": its * (lin_flops + grad_flops + cg * cg_flops + acc_flops) + acc_flops,
    }


def least_seconds(c: dict) -> tuple:
    """(seconds, the bound: 'bytes' or 'flops') at the published peaks."""
    tb, tf = c["bytes"] / PEAK_BYTES_PER_S, c["flops"] / PEAK_FP32_FLOPS
    return (tb, "bytes") if tb >= tf else (tf, "flops")
