"""The readings that the limits of ``correct`` are set from, at a cell's own
size (not run by the benchmark's runs):

    python3 slambench/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--faults] [--out F]
    python3 slambench/calibrate.py --workload <cell> --seeds 1,2,3 --survey [--out F]

For each seed it makes the cell's map, warms the program's solve as a run
does, solves twice (the two must be bit-equal) and compares with the float64
reference: the program's readings, whose largest over a dozen seeds is each
limit's lower reading. ``--control`` also puts the control in the program's
place (for the visual bundle adjustment the reference computed in TF32): its
smallest reading is the upper one. ``--faults`` reads the faults that the
problem plants at the cell's size (for the visual bundle adjustment those of
``slambench/tests/test_slambench_faults.py``: the solve over half the
landmarks' observations, one landmark of the answer moved by (1, 1, 1) m).
Everything is reached through the cell's problem module
(``slambench/problems/``), so a new problem calibrates with this tool as it
is. One JSON line a seed goes to standard output and to ``--out``.
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

from slambench import run  # noqa: E402


def bit_equal(a, b) -> bool:
    """Two answers the same, bit for bit (numpy arrays, numbers, or tuples
    of them)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(bit_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def survey(cell_name: str, seed: int, device) -> dict:
    """What the reference reports on the seed's map, and what the map as
    handed over reads against it."""
    cell, config = run.load_cell(ROOT, cell_name)
    problem = run.load_problem(ROOT, config)
    maparr = problem.make_map(config, cell, seed)
    stats = {}
    ref = problem.reference(config, cell, maparr, device, stats)
    still = problem.unchanged(maparr, stats, ref)
    return {"cell": cell_name, "seed": seed, **stats, "unchanged": still,
            "told_apart": not run.passes(still, cell["limits"], problem.NAMES)}


def readings(cell_name: str, seed: int, control: bool, faults: bool, device) -> dict:
    cell, config = run.load_cell(ROOT, cell_name)
    problem = run.load_problem(ROOT, config)
    t0 = time.perf_counter()
    maparr = problem.make_map(config, cell, seed)
    solver = problem.Solver(config, cell, maparr, device)
    solver.warm()
    a = solver.solve([])
    b = solver.solve([])
    t1 = time.perf_counter()
    stats = {}
    ref = problem.reference(config, cell, maparr, device, stats)
    t2 = time.perf_counter()
    out = {"cell": cell_name, "seed": seed, "program": problem.gaps(a, ref),
           "bit_equal_solves": bit_equal(a, b), "shapes": solver.shapes,
           "program_s": t1 - t0, "reference_s": t2 - t1, **stats,
           "unchanged": problem.unchanged(maparr, stats, ref)}
    if control:
        out["control"] = problem.gaps(problem.reference(config, cell, maparr, device,
                                                        control=True), ref)
    if faults:
        out.update(problem.faults(solver, a, ref))
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
