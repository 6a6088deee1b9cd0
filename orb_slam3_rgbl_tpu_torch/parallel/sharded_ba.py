"""Distributed global bundle adjustment with the landmarks sharded over the
ranks (counterpart of ``orb_slam3_rgbl_tpu.parallel.sharded_ba``; the
reference's ``Optimizer::GlobalBundleAdjustemnt``, run after a loop closure).

Each rank holds every pose and its own contiguous slice of the landmarks with
their observation rows (``shard_problem``). A rank linearizes its own
observations; what a sum over all observations needs is all-reduced over the
group (``parallel/mesh.Mesh.all_reduce``: NCCL between cards, gloo on the
CPU or for ranks that share a card), and the landmark state never leaves its
rank. Every rank takes the same accept decision from the same reduced bits,
so the replicated poses stay bit-equal across ranks.

* ``make_distributed_pcg_ba``: the production path, the port's
  ``optim/global_ba.global_bundle_adjust`` with its ``all_reduce`` points
  (cost, active count, gradient and preconditioner pose blocks at assembly;
  the pose half of H·v and the landmark halves of the two dot products in
  each CG step; the new cost and active count at acceptance), O(K·6) bytes a
  CG step whatever the landmark count.
* ``make_distributed_ba``: the dense-Schur oracle that the PCG path is held
  to: every iteration all-reduces the (6K)² reduced camera system, solves it
  on every rank and back-substitutes each rank's landmarks.

``solve_on_ranks`` spawns a group and runs either solver on a host problem.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.device import synchronize
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.optim import global_ba
from orb_slam3_rgbl_tpu_torch.optim.local_ba import (
    BAProblem, _back_substitute, _linearize, _reduced_system, _solve_reduced,
)
from orb_slam3_rgbl_tpu_torch.parallel.mesh import Mesh, landmark_sharding, run_ranks

LANDMARK_FIELDS = ("landmarks", "lm_valid", "obs_kf", "obs_uv", "obs_ur", "obs_inv_sigma2",
                   "obs_mask")


def shard_problem(problem: BAProblem, rank: int, world_size: int, device) -> BAProblem:
    """Rank ``rank``'s part of ``problem`` on ``device``: the poses,
    ``pose_fixed`` and ``pose_valid`` whole, the landmark-major arrays
    (``LANDMARK_FIELDS``) its ``landmark_sharding`` slice."""
    sl = landmark_sharding(problem.landmarks.shape[0], rank, world_size)
    return BAProblem(*(torch.as_tensor(getattr(problem, f))[sl if f in LANDMARK_FIELDS else slice(None)]
                       .to(device) for f in BAProblem._fields))


def comm_per_lm_iter_bytes(n_poses: int, cg_iters: int) -> int:
    """The JAX scaling tool's budget of one LM iteration (f32): g_p, the Hpp
    blocks and the cost at assembly, H·v's pose half each CG step, the cost
    and count at acceptance: K·6·4·(C+1) + K·144 + 16."""
    return n_poses * 6 * 4 * (cg_iters + 1) + n_poses * 144 + 16


def comm_bytes(n_poses: int, cg_iters: int) -> int:
    """Bytes a rank all-reduces in one LM iteration of the PCG path: the
    JAX budget (``comm_per_lm_iter_bytes``) plus the CG steps' landmark dot
    products (two scalars a step) and the first one, 8·C + 4 more.
    Independent of the landmark count."""
    return comm_per_lm_iter_bytes(n_poses, cg_iters) + 8 * cg_iters + 4


def make_distributed_ba(mesh: Mesh, cam, iterations: int = 10, huber_iters: int = 7):
    """The dense-Schur oracle (test and check only: its collective is the
    (6K)² reduced system, ~280 MB an iteration at K ≈ 1.4k). Returns
    ``run(problem) → (poses, landmarks)`` for this rank's shard: damping
    1e-4 × 0.7 an iteration, every step taken."""

    def run(problem: BAProblem):
        K = problem.poses.shape[0]
        dtype, dev = problem.poses.dtype, problem.poses.device
        all_obs = torch.ones_like(problem.obs_mask)
        poses, lms = problem.poses, problem.landmarks
        lam = torch.full((), 1e-4, dtype=dtype, device=dev)
        for it in range(iterations):
            P = problem._replace(poses=poses, landmarks=lms)
            r, Jp, Jl, w, *_ = _linearize(P, cam, it < huber_iters, all_obs)
            S_loc, rhs_loc, Vinv, b_l, Wpl = _reduced_system(P, r, Jp, Jl, w, lam, K)
            # the collective: the reduced camera system summed over the shards
            S, rhs = global_ba._summed(mesh.all_reduce, S_loc, rhs_loc)
            delta_p = _solve_reduced(P, S.reshape(6 * K, 6 * K), rhs)
            delta_l = _back_substitute(P, delta_p, Vinv, b_l, Wpl)
            poses = lie.se3_normalize(lie.se3_mul(lie.se3_exp(delta_p), poses))
            lms = lms + delta_l
            lam = lam * 0.7
        return poses, lms

    return run


def make_distributed_pcg_ba(mesh: Mesh, cam, iterations: int = 8, cg_iters: int = 24,
                            huber_iters: int = 5):
    """The matrix-free PCG solve over the group. Returns ``run(problem,
    segments) → GBAResult`` for this rank's shard (poses replicated,
    landmarks and inlier flags this rank's, the cost summed over the ranks);
    ``segments``: the shard's ``global_ba.PoseSegments`` (building them
    waits for the device once; the solve does not)."""

    def run(problem: BAProblem, segments: global_ba.PoseSegments):
        return global_ba.global_bundle_adjust(problem, cam, segments, iterations=iterations,
                                              cg_iters=cg_iters, huber_iters=huber_iters,
                                              all_reduce=mesh.all_reduce)

    return run


def _solve_jobs(mesh: Mesh, jobs, repeats: int):
    """The rank function of ``solve_on_ranks``."""
    out = []
    for arrays, cam, solver, kw in jobs:
        full = BAProblem(*(torch.from_numpy(arrays[f]) for f in BAProblem._fields))
        problem = shard_problem(full, mesh.rank, mesh.world_size, mesh.device)
        if solver == "pcg":
            run = make_distributed_pcg_ba(mesh, cam, **kw)
            segments = global_ba.PoseSegments(problem.obs_kf, problem.obs_mask,
                                              problem.poses.shape[0])
            solve = lambda: run(problem, segments)[:2]    # noqa: E731
        elif solver == "dense":
            solve = lambda: make_distributed_ba(mesh, cam, **kw)(problem)   # noqa: E731
        else:
            raise ValueError(f"solver {solver!r}: 'pcg' or 'dense'")
        rec = {"poses": [], "landmarks": [], "seconds": [], "collectives": [], "bytes": [],
               "n_landmarks": problem.landmarks.shape[0]}
        for _ in range(repeats):
            before = dict(mesh.stats)
            synchronize(mesh.device)
            t0 = time.perf_counter()
            poses, lms = solve()
            synchronize(mesh.device)
            rec["seconds"].append(time.perf_counter() - t0)
            rec["poses"].append(poses.cpu().numpy())
            rec["landmarks"].append(lms.cpu().numpy())
            for k in ("collectives", "bytes"):
                rec[k].append(mesh.stats[k] - before[k])
        out.append(rec)
    return out


def problem_arrays(problem: BAProblem) -> dict:
    """A ``BAProblem`` as host numpy arrays by field (what a rank is sent)."""
    return {f: np.ascontiguousarray(getattr(problem, f).detach().cpu().numpy())
            for f in BAProblem._fields}


def solve_on_ranks(jobs, world_size: int, device=None, repeats: int = 1, threads: int = 1,
                   timeout_s: float = 600.0) -> list:
    """Solve every job — ``(problem, cam, solver, kwargs)`` with ``solver``
    'pcg' (``make_distributed_pcg_ba``) or 'dense' (``make_distributed_ba``)
    — ``repeats`` times on a spawned group of ``world_size`` ranks on
    ``device`` (default ``cuda``: NCCL ranks one a card, or gloo ranks
    sharing the cards; ``parallel/mesh.rank_layout``). Returns
    ``out[job][rank]``: a dict of per-repeat lists ``poses`` (K, 7),
    ``landmarks`` (the rank's slice), ``seconds`` (host, synchronized),
    ``collectives`` and ``bytes`` (what the rank all-reduced), and
    ``n_landmarks``."""
    sent = [(problem_arrays(p), cam, solver, dict(kw)) for p, cam, solver, kw in jobs]
    per_rank = run_ranks(_solve_jobs, (sent, repeats), world_size, device, threads, timeout_s)
    return [[per_rank[r][j] for r in range(world_size)] for j in range(len(jobs))]
