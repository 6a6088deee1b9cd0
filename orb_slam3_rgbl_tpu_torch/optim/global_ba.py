"""Global bundle adjustment: matrix-free preconditioned CG (counterpart of
``orb_slam3_rgbl_tpu.optim.global_ba``; reference
``Optimizer::GlobalBundleAdjustemnt``, run after a loop closure).

The windowed Schur solver (``local_ba``) assembles an explicit reduced
camera system, whose coupling term is O(M·K) memory: no good for a whole
map. Here the normal equations are never materialized: each CG iteration
applies

    H·v = Jᵀ W (J v) + λ D v

through the observation table, with a block-Jacobi preconditioner (6×6 pose
and 3×3 landmark inverses): O(observations) work per iteration and
O(K + M) memory.

The sums of per-observation values onto their poses run ~3 times per CG
step. ``obs_kf`` is fixed for the whole solve, so the observations are
sorted by keyframe once (``PoseSegments``): each pose then gathers its own
observations into a padded row and sums it, in the same order on every
run, so two solves of one problem give the same bits (an atomic
scatter-add would not, and a last-bit difference can flip the accept
test). The outer loop runs on the host and every decision in it is a
``torch.where`` on device tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.optim.local_ba import BAProblem, _diag_part, _linearize
from orb_slam3_rgbl_tpu_torch.optim.pose_opt import CHI2_MONO, CHI2_STEREO


class GBAResult(NamedTuple):
    poses: torch.Tensor
    landmarks: torch.Tensor
    obs_inlier: torch.Tensor
    cost: torch.Tensor


class PoseSegments:
    """The observations of each pose, as a (K, L) table of indices into the
    flattened (M·D) observation axis; unused slots point at an appended
    zero row. ``L`` is the number of observations of the busiest pose."""

    def __init__(self, obs_kf: torch.Tensor, obs_mask: torch.Tensor, n_poses: int):
        K, dev = n_poses, obs_kf.device
        n = obs_kf.numel()
        key = torch.where(obs_mask, obs_kf, K).reshape(-1)           # masked → past the end
        # sized from the data: one wait for the device, before the solve
        counts = torch.zeros(K + 1, dtype=torch.int64, device=dev).index_add(
            0, key, torch.ones_like(key))
        L = max(int(counts[:K].max()), 1)
        order = torch.argsort(key, stable=True)
        skey = key[order]
        starts = torch.searchsorted(skey, torch.arange(K + 1, device=dev))
        rank = torch.arange(n, device=dev) - starts[skey]
        keep = skey < K
        # kept entries have distinct (pose, rank) targets; the masked land in a spare row
        table = torch.full((K + 1, L), n, dtype=torch.int64, device=dev)
        table[torch.where(keep, skey, K), torch.where(keep, rank, 0)] = torch.where(keep, order, n)
        self.table = table[:K]
        self.n_obs = n

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """(M, D, C) per-observation values → (K, C) per-pose sums."""
        flat = values.reshape(self.n_obs, values.shape[-1])
        flat = torch.cat([flat, torch.zeros_like(flat[:1])], dim=0)
        return flat[self.table].sum(dim=1)


def ba_cost(problem: BAProblem, cam: PinholeCamera) -> torch.Tensor:
    """The plain (no Huber) cost of a problem as it stands: what
    ``GBAResult.cost`` reports after a solve."""
    return _linearize(problem, cam, False, torch.ones_like(problem.obs_mask))[-1]


def global_bundle_adjust(problem: BAProblem, cam: PinholeCamera, segments: PoseSegments,
                         iterations: int = 8,
                         cg_iters: int = 24, huber_iters: int = 5) -> GBAResult:
    """LM outer loop with PCG inner solves over the full (pose, landmark)
    state. Fixed/invalid poses and invalid landmarks are projected out of
    the Krylov space by masking.

    ``segments``: the ``PoseSegments`` of this problem's observation table
    (they serve every solve on that table; building them waits for the
    device once, so nothing in the solve does)."""
    K = problem.poses.shape[0]
    M, D = problem.obs_kf.shape
    dtype, dev = problem.poses.dtype, problem.poses.device
    all_obs = torch.ones_like(problem.obs_mask)

    pose_free = ((~problem.pose_fixed) & problem.pose_valid)[:, None]      # (K, 1)
    lm_free = problem.lm_valid[:, None]                                     # (M, 1)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def dot(a, b):
        return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

    poses, lms = problem.poses, problem.landmarks
    lam = torch.full((), 1e-3, dtype=dtype, device=dev)
    for it in range(iterations):
        P = problem._replace(poses=poses, landmarks=lms)
        use_huber = it < huber_iters
        r, Jp, Jl, w, chi2, active, cost = _linearize(P, cam, use_huber, all_obs)
        # gradient g = Jᵀ W r
        wr = w[..., None] * r                                              # (M, D, 3)
        g_p = segments.sum(torch.einsum("mdij,mdi->mdj", Jp, wr)) * pose_free
        g_l = torch.einsum("mdij,mdi->mj", Jl, wr) * lm_free

        # block-Jacobi preconditioner (damped diagonal blocks)
        wJp = w[..., None, None] * Jp
        Hpp_diag = segments.sum((wJp.transpose(-1, -2) @ Jp).reshape(M, D, 36)).reshape(K, 6, 6)
        Hll_diag = torch.einsum("mdij,md,mdik->mjk", Jl, w, Jl)
        Hpp_d = Hpp_diag + lam * _diag_part(Hpp_diag) + 1e-7 * eye6
        Hll_d = Hll_diag + lam * _diag_part(Hll_diag) + 1e-7 * eye3
        Minv_p = torch.linalg.inv_ex(torch.where(pose_free[..., None], Hpp_d, eye6))[0]
        Minv_l = torch.linalg.inv_ex(torch.where(lm_free[..., None], Hll_d, eye3))[0]
        lam_p = lam * torch.diagonal(Hpp_diag, dim1=-2, dim2=-1) + 1e-7    # (K, 6)
        lam_l = lam * torch.diagonal(Hll_diag, dim1=-2, dim2=-1) + 1e-7    # (M, 3)

        def H_apply(v_p, v_l):
            Jv = (torch.einsum("mdij,mdj->mdi", Jp, v_p[P.obs_kf])
                  + torch.einsum("mdij,mj->mdi", Jl, v_l))
            wJv = w[..., None] * Jv
            Hp = segments.sum(torch.einsum("mdij,mdi->mdj", Jp, wJv))
            Hl = torch.einsum("mdij,mdi->mj", Jl, wJv)
            return (Hp + lam_p * v_p) * pose_free, (Hl + lam_l * v_l) * lm_free

        def precond(v_p, v_l):
            return (torch.einsum("kij,kj->ki", Minv_p, v_p) * pose_free,
                    torch.einsum("mij,mj->mi", Minv_l, v_l) * lm_free)

        # PCG for H x = −g
        rr = (-g_p, -g_l)
        x = (torch.zeros_like(g_p), torch.zeros_like(g_l))
        z = precond(*rr)
        p = z
        rz = dot(rr, z)
        for _ in range(cg_iters):
            Ap = H_apply(*p)
            alpha = rz / dot(p, Ap).clamp_min(1e-20)
            x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
            rr = (rr[0] - alpha * Ap[0], rr[1] - alpha * Ap[1])
            z = precond(*rr)
            rz_new = dot(rr, z)
            beta = rz_new / rz.clamp_min(1e-20)
            p = (z[0] + beta * p[0], z[1] + beta * p[1])
            rz = rz_new
        dp, dl = x

        new_poses = lie.se3_normalize(lie.se3_mul(lie.se3_exp(dp), poses))
        new_lms = lms + dl
        P2 = problem._replace(poses=new_poses, landmarks=new_lms)
        *_, active2, cost_new = _linearize(P2, cam, use_huber, all_obs)
        # reject diverged steps: NaN or an emptied active set collapses
        # the cost to 0 and would otherwise be accepted
        accept = ((cost_new < cost) & torch.isfinite(cost_new)
                  & (2 * active2.sum() >= active.sum()))
        poses = torch.where(accept, new_poses, poses)
        lms = torch.where(accept, new_lms, lms)
        lam = torch.where(accept, (lam * 0.4).clamp_min(1e-8), (lam * 5.0).clamp_max(1e4))

    P = problem._replace(poses=poses, landmarks=lms)
    _, _, _, _, chi2, active, cost = _linearize(P, cam, False, all_obs)
    th = torch.where(problem.obs_ur >= 0, CHI2_STEREO, CHI2_MONO)
    return GBAResult(poses=poses, landmarks=lms, obs_inlier=active & (chi2 <= th), cost=cost)
