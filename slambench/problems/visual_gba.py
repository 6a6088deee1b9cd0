"""The visual whole-map bundle adjustment after a loop correction: the map of
``mapgen``, the port's solve of ``program``, the float64 ``reference`` and
the four numbers of ``compare``, bound to the roles that
``slambench/problems/__init__.py`` sets out. An answer is the tuple
(poses (K, 7) Tcw as quaternion and translation, landmarks (M, 3), cost)."""

from __future__ import annotations

import numpy as np
import torch

from slambench import compare, mapgen, program
from slambench import reference as plain

SPAN_SOLVE = program.SPAN_SOLVE
SPAN_PREFIX = "gba."
NAMES = compare.NAMES
REFERENCE = plain.__file__


def make_map(config: dict, cell: dict, seed: int) -> dict:
    return mapgen.generate(config, cell, seed)


class Solver(program.Solver):
    def __init__(self, config: dict, cell: dict, maparr: dict, device: torch.device):
        super().__init__(config, cell, maparr, mapgen.inv_sigma2(config["orb"]), device)


def as_pose7(R, t):
    """Rotation matrices and translations as the program's (K, 7) poses."""
    return np.concatenate([mapgen.matrix_to_quat(R), t], -1)


def reference(config: dict, cell: dict, maparr: dict, device, stats: dict = None,
              control: bool = False):
    """The float64 reference as ``compare.Reference``; with ``control`` the
    reference in TF32 (float32, every product's operands rounded to TF32),
    as an answer."""
    args = (maparr, mapgen.inv_sigma2(config["orb"]), config["camera"], config["max_obs"],
            cell["schedule"])
    if control:
        R, t, X, cost = plain.run(*args, plain.Arith(torch.float32, tf32=True), device, stats)
        return as_pose7(R, t), X, cost
    return compare.against(plain.run(*args, plain.Arith(torch.float64), device, stats), maparr,
                           config["camera"])


def gaps(out, ref: compare.Reference) -> dict:
    return compare.gaps(*out, ref)


def unchanged(maparr: dict, stats: dict, ref: compare.Reference) -> dict:
    return compare.unchanged(maparr, stats["start_cost"], ref)


def half_observations(solve_fn):
    """``global_bundle_adjust`` over the observations of every other landmark."""
    def broken(problem, *a, **k):
        keep = torch.zeros_like(problem.obs_mask)
        keep[::2] = True
        return solve_fn(problem._replace(obs_mask=problem.obs_mask & keep), *a, **k)
    return broken


def faults(solver: Solver, out, ref: compare.Reference) -> dict:
    """One landmark of the answer moved by (1, 1, 1) m; the solve over half
    the landmarks' observations."""
    from orb_slam3_rgbl_tpu_torch.optim import global_ba
    moved = out[1].copy()
    moved[0] += np.float32(1.0)
    found = {"fault_answer_altered": gaps((out[0], moved, out[2]), ref)}
    orig = global_ba.global_bundle_adjust
    global_ba.global_bundle_adjust = half_observations(orig)
    try:
        found["fault_half_observations"] = gaps(solver.solve([]), ref)
    finally:
        global_ba.global_bundle_adjust = orig
    return found
