"""The readings that the limits of ``correct`` are set from, at a cell's own
size (not run by the benchmark's runs):

    python3 slambench/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--faults] [--out F]
    python3 slambench/calibrate.py --workload <cell> --seeds 1,2,3 --survey [--out F]

For each seed it makes the cell's map, warms the program's solve as a run
does, solves twice (the two must be bit-equal) and compares with the float64
reference: the program's readings, whose largest over a dozen seeds is each
limit's lower reading. ``--control`` also puts the reference computed in
TF32 (``reference.Arith(float32, tf32=True)``) in the program's place: its
smallest reading is the upper one. ``--faults`` reads the faults that
``slambench/tests/test_slambench_faults.py`` plants at a small size: the solve that
returns its state unchanged, the solve over half the landmarks'
observations, one landmark of the answer moved by (1, 1, 1) m. One JSON line a seed
goes to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slambench import compare, mapgen, program, reference, run  # noqa: E402


def as_pose7(R, t):
    return np.concatenate([mapgen.matrix_to_quat(R), t], -1)


def half_observations(solve_fn):
    """``global_bundle_adjust`` over the observations of every other landmark."""
    def broken(problem, *a, **k):
        keep = torch.zeros_like(problem.obs_mask)
        keep[::2] = True
        return solve_fn(problem._replace(obs_mask=problem.obs_mask & keep), *a, **k)
    return broken


def survey(cell_name: str, seed: int, device) -> dict:
    """The steps the reference keeps on the seed's map, and what the map as
    handed over reads against it."""
    cell, config = run.load_cell(ROOT, cell_name)
    maparr = mapgen.generate(config, cell, seed)
    inv_s2 = mapgen.inv_sigma2(config["orb"])
    stats = {}
    ref = compare.against(
        reference.run(maparr, inv_s2, config["camera"], config["max_obs"], cell["schedule"],
                      reference.Arith(torch.float64), device, stats), maparr, config["camera"])
    still = compare.unchanged(maparr, stats["start_cost"], ref)
    return {"cell": cell_name, "seed": seed, "accepted": stats["accepted"], "unchanged": still,
            "told_apart": not compare.passes(still, cell["limits"])}


def readings(cell_name: str, seed: int, control: bool, faults: bool, device) -> dict:
    cell, config = run.load_cell(ROOT, cell_name)
    t0 = time.perf_counter()
    maparr = mapgen.generate(config, cell, seed)
    inv_s2 = mapgen.inv_sigma2(config["orb"])
    solver = program.Solver(config, cell, maparr, inv_s2, device)
    solver.warm()
    a = solver.solve([])
    b = solver.solve([])
    same = all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2])) and a[2] == b[2]
    t1 = time.perf_counter()
    args = (maparr, inv_s2, config["camera"], config["max_obs"], cell["schedule"])
    stats = {}
    ref = compare.against(reference.run(*args, reference.Arith(torch.float64), device, stats),
                          maparr, config["camera"])
    t2 = time.perf_counter()
    out = {"cell": cell_name, "seed": seed, "program": compare.gaps(*a, ref),
           "bit_equal_solves": bool(same), "shapes": solver.shapes,
           "program_s": t1 - t0, "reference_s": t2 - t1, "accepted": stats["accepted"],
           "unchanged": compare.unchanged(maparr, stats["start_cost"], ref)}
    if control:
        R, t, X, c = reference.run(*args, reference.Arith(torch.float32, tf32=True), device)
        out["control"] = compare.gaps(as_pose7(R, t), X, c, ref)
    if faults:
        from orb_slam3_rgbl_tpu_torch.optim import global_ba
        moved = a[1].copy()
        moved[0] += np.float32(1.0)
        out["fault_answer_altered"] = compare.gaps(a[0], moved, a[2], ref)
        orig = global_ba.global_bundle_adjust
        global_ba.global_bundle_adjust = half_observations(orig)
        try:
            out["fault_half_observations"] = compare.gaps(*solver.solve([]), ref)
        finally:
            global_ba.global_bundle_adjust = orig
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--survey", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate.py measures on a CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        dev = torch.device("cuda:0")
        r = (survey(args.workload, int(s), dev) if args.survey
             else readings(args.workload, int(s), args.control, args.faults, dev))
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
