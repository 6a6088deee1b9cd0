"""Scaling of the landmark-sharded global BA over ranks (counterpart of the
root ``tools/bench_scaling.py``).

Runs the matrix-free PCG solve (``parallel/sharded_ba.make_distributed_pcg_ba``,
the production multi-device path; the dense-Schur solve is the test oracle)
on one problem (``synthetic.synth_gba_problem``: K = 768 poses, M = 262,144
landmarks seen 4 times each, 3 LM iterations × 40 CG steps) over 1, 2, 4
and 8 ranks, one spawned group per rank count, and prints one row per rank
count: the steady and first solve's host seconds (the slowest rank's,
synchronized), landmarks per shard, the final cost and whether it agrees
with one rank's within 2% (sharding must not change the math), the speedup
over one rank, the host's cores, the JAX tool's analytic budget of bytes
all-reduced per LM iteration (K·6·4·(C+1) + K·144 + 16, independent of M)
and beside it the bytes a rank passed to ``all_reduce`` per LM iteration in
the steady solve, as counted by its ``Mesh``.

Where the ranks run (``parallel/mesh.rank_layout``): on the CPU, gloo ranks
on this host's cores; on cards, rank r on card r over NCCL while there are cards enough,
otherwise gloo ranks sharing the cards (NCCL refuses two ranks on one card).
Ranks that share cores or a card show the communication structure and the
agreement, not speedup: each row's ``note`` says which it is.

    python -m orb_slam3_rgbl_tpu_torch.tools.bench_scaling [out.json] \\
        [--ranks 1,2,4,8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.parallel import mesh, sharded_ba

K, D, M = 768, 4, 262144   # M/8 = 32k landmarks a shard at 8 ranks, >> K
ITERS, CG = 3, 40
RANKS = (1, 2, 4, 8)
COST_AGREEMENT = 0.02


def layout_note(n_ranks: int, device: torch.device) -> str:
    """What a row of ``n_ranks`` ranks on ``device`` can show."""
    backend, _ = mesh.rank_layout(n_ranks, device)
    if device.type == "cpu":
        return (f"{n_ranks} gloo ranks on the CPU's {os.cpu_count()} cores: validates the "
                f"sharding, the collectives and the agreement, not speedup")
    name = torch.cuda.get_device_name(0)
    if backend == "nccl":
        return f"{n_ranks} NCCL ranks, one a card ({name})"
    return (f"{n_ranks} gloo ranks sharing {torch.cuda.device_count()} card(s) ({name}): "
            f"shows the communication structure and the agreement, not speedup")


def run_one(n_ranks: int, problem, cam, iters: int, cg: int, device: torch.device,
            threads: int) -> dict:
    """One rank count: the solve twice on a fresh group."""
    from orb_slam3_rgbl_tpu_torch.optim import global_ba

    ranks = sharded_ba.solve_on_ranks(
        [(problem, cam, "pcg", dict(iterations=iters, cg_iters=cg))], n_ranks, device,
        repeats=2, threads=threads, timeout_s=3000.0)[0]
    poses = torch.from_numpy(ranks[0]["poses"][1]).to(device)
    lms = torch.from_numpy(np.concatenate([r["landmarks"][1] for r in ranks])).to(device)
    on_dev = problem._replace(**{f: getattr(problem, f).to(device) for f in problem._fields})
    cost = global_ba.ba_cost(on_dev._replace(poses=poses, landmarks=lms), cam)
    return dict(n_dev=n_ranks, steady_s=max(r["seconds"][1] for r in ranks),
                first_s=max(r["seconds"][0] for r in ranks),
                lm_per_shard=max(r["n_landmarks"] for r in ranks), final_cost=float(cost),
                all_reduced_per_lm_iter_bytes=max(r["bytes"][1] for r in ranks) / iters,
                note=layout_note(n_ranks, device))


def scaling_rows(ranks, n_poses: int, n_landmarks: int, n_obs: int, iters: int, cg: int,
                 device, threads=None) -> list:
    """The tool's rows for each rank count of ``ranks`` (the first is the
    baseline) on ``synth_gba_problem(n_poses, n_landmarks, n_obs)``;
    ``threads``: torch threads a rank (default: the host's cores shared)."""
    from orb_slam3_rgbl_tpu_torch import synthetic
    from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
    from orb_slam3_rgbl_tpu_torch.device import resolve

    device = resolve(device)
    cam = kitti_rgbl_config().camera
    problem, _, _ = synthetic.synth_gba_problem(n_poses, n_landmarks, n_obs, cam, device="cpu")
    rows = [run_one(n, problem, cam, iters, cg, device,
                    threads or max(1, (os.cpu_count() or 1) // n)) for n in ranks]
    base, cost0 = rows[0]["steady_s"], rows[0]["final_cost"]
    for r in rows:
        note = r.pop("note")
        r["speedup_vs_1dev"] = base / r["steady_s"]
        # sharding must not change the math: the all-reduced solve agrees
        r["cost_agrees"] = bool(abs(r["final_cost"] - cost0) <= COST_AGREEMENT * abs(cost0) + 1e-6)
        r["physical_cores"] = os.cpu_count()
        r["comm_per_lm_iter_bytes"] = sharded_ba.comm_per_lm_iter_bytes(n_poses, cg)
        r["all_reduced_per_lm_iter_bytes"] = r.pop("all_reduced_per_lm_iter_bytes")
        r["note"] = note
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", help="also write the rows to this JSON file")
    ap.add_argument("--ranks", default=",".join(map(str, RANKS)),
                    help="rank counts, the first the baseline (default 1,2,4,8)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from orb_slam3_rgbl_tpu_torch.device import resolve

    device = resolve(args.device)
    rows = scaling_rows([int(n) for n in args.ranks.split(",")], K, M, D, ITERS, CG, device)
    for r in rows:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
