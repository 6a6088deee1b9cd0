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

A CG step runs in ``ops/gba_cuda``: on the card as hand-written kernels
(``csrc/gba.cu``) that read each live slot's Jacobians once a step and fuse
the preconditioner with the step's vector updates; on the CPU as their plain
PyTorch versions. So does the LM iteration around it: the linearization
with its gradient and diagonal blocks (``linearize``), the step's update
(``gba_cuda.apply_step``) and the accept test's cost (``lm_cost``), whose
per-slot arithmetic and order of sums are the linearization's; on the card
as ``gba_cuda``'s kernels, on the CPU as ``linearize_plain`` /
``cost_plain`` here. The damping, the block inverses and the accept
decision stay PyTorch ops.

The LM loop itself, ``lm_loop``, is the one both whole-map solves run:
``global_bundle_adjust`` here on 6-wide poses, and
``global_inertial_ba.global_inertial_bundle_adjust`` on 15-wide inertial
states. It owns the schedule, the damping, the damped block-Jacobi set-up,
the PCG steps, the accept test and the inlier class; each solve hands it
its linearization (``normal_blocks`` builds the visual half of both), its
H·v, its step and its cost.

The sums of per-observation values onto their poses run once a CG step and
once a linearization. ``obs_kf`` is fixed for the whole solve, so the
observations are sorted by keyframe once (``PoseSegments``): each pose then
gathers its own observations into a padded row and sums it, in the same
order on every run, so two solves of one problem give the same bits (an atomic
scatter-add would not, and a last-bit difference can flip the accept
test). The outer loop runs on the host and every decision in it is a
``torch.where`` on device tensors.

The same solve runs landmark-sharded over ranks (``parallel/sharded_ba``):
each rank holds every pose and its own slice of the landmarks, and
``all_reduce`` adds over the ranks what a sum over all observations needs —
the cost, the active count, the gradient and preconditioner pose blocks at
assembly; the pose half of H·v with the landmark half of the first CG dot
product, then the landmark half of the second, in each CG step; the new cost
and active count at acceptance. Values summed at one point travel in one
flat buffer: one collective each. Without ``all_reduce`` the arithmetic is
the single-device solve's, op for op.

Under ``torch.profiler`` each stage is a span (``utils/profiling.tracer``):
``gba.segments`` around ``PoseSegments``; ``gba.lm`` around a solve, and
inside it, per LM iteration, ``gba.linearize`` (linearization, gradient,
landmark and pose blocks), ``gba.precond`` (damping, inverses, the PCG
set-up), one ``gba.cg_step`` per CG step and ``gba.accept`` (the update, its
cost, the accept test, the damping), then ``gba.final``. They
follow one another with nothing between them, so their device windows tile
the iteration. Without a profiler they cost one check a call.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.ops import gba_cuda
from orb_slam3_rgbl_tpu_torch.optim.local_ba import BAProblem, _diag_part, _linearize
from orb_slam3_rgbl_tpu_torch.optim.pose_opt import (CHI2_MONO, CHI2_STEREO, HUBER_MONO,
                                                      HUBER_STEREO)
from orb_slam3_rgbl_tpu_torch.utils.profiling import tracer


HUBER = (HUBER_STEREO, HUBER_MONO)     # the Huber thresholds of a stereo and a mono slot


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
        with tracer(dev)("gba.segments"):
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
            table[torch.where(keep, skey, K), torch.where(keep, rank, 0)] = \
                torch.where(keep, order, n)
            self.table = table[:K]
            self.n_obs = n

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """(M, D, C) per-observation values → (K, C) per-pose sums."""
        flat = values.reshape(self.n_obs, values.shape[-1])
        flat = torch.cat([flat, torch.zeros_like(flat[:1])], dim=0)
        return flat[self.table].sum(dim=1)


def _summed(all_reduce, *parts):
    """``parts`` added over the ranks by one ``all_reduce`` of a flat buffer
    in the first part's dtype (integer counts below 2²⁴ stay exact in f32);
    ``parts`` as they are without ``all_reduce``."""
    if all_reduce is None:
        return parts
    flat = torch.cat([p.reshape(-1).to(parts[0].dtype) for p in parts])
    all_reduce(flat)
    return tuple(torch.split(flat, [p.numel() for p in parts]))


def pcg_start(precond, g, dot):
    """PCG for H x = −g from x = 0, after the preconditioner's first apply:
    the state (x, r, z, p, r·z) that ``pcg_steps`` takes. ``g`` and each
    vector a (state, landmark) pair; ``dot`` their inner product."""
    rr = (-g[0], -g[1])
    x = (torch.zeros_like(g[0]), torch.zeros_like(g[1]))
    z = precond(*rr)
    return x, rr, z, z, dot(rr, z)


def pcg_steps(cg, H_apply_dot, precond, dot, cg_iters: int, span):
    """``cg_iters`` PCG steps from ``cg`` (``pcg_start``), one
    ``gba.cg_step`` span each; returns the iterate x. ``H_apply_dot(v)``:
    (H·v, v·H·v); ``precond``: the ``gba_cuda.BlockJacobi`` of the set-up.
    The step's vectors die with the call: only x outlives it."""
    x, rr, z, p, rz = cg
    for _ in range(cg_iters):
        with span("gba.cg_step"):
            Ap, pAp = H_apply_dot(*p)
            # x + α·p, rr − α·Ap and z = M⁻¹·rr, α = rz / pAp
            x, rr, z = precond.update(rz, pAp, x, rr, p, Ap)
            rz_new = dot(rr, z)
            p = gba_cuda.cg_direction(rz_new, rz, z, p)       # z + β·p, β = rz_new / rz
            rz = rz_new
    return x


def lm_accept(cost, n_active, cost_new, n_active_new, lam):
    """Whether an LM step is kept, and the damping after it: kept where the
    cost is lower, finite and keeps half the active observations (NaN or an
    emptied active set collapses the cost to 0 and would otherwise be
    accepted); the damping × 0.4 (≥ 1e-8) on a kept step, × 5 (≤ 1e4) on a
    rejected one."""
    accept = (cost_new < cost) & torch.isfinite(cost_new) & (2 * n_active_new >= n_active)
    return accept, torch.where(accept, (lam * 0.4).clamp_min(1e-8), (lam * 5.0).clamp_max(1e4))


def normal_blocks(r, Jp, Jl, w, cost, active, segments, lm_free) -> gba_cuda.Linearization:
    """The gradient and the block-Jacobi diagonal blocks from the residuals
    ``r`` (M, D, 3), Jacobians and weights of every slot, the pose parts
    summed by ``segments``: the visual half of both whole-map solves."""
    M, D = w.shape
    wr = w[..., None] * r                                              # (M, D, 3)
    wJp = w[..., None, None] * Jp
    g_p = segments.sum(torch.einsum("mdij,mdi->mdj", Jp, wr))
    Hpp_diag = segments.sum((wJp.transpose(-1, -2) @ Jp).reshape(M, D, 36))
    return gba_cuda.Linearization(Jp=Jp, Jl=Jl, w=w, g_p=g_p, Hpp_diag=Hpp_diag,
                                  g_l=torch.einsum("mdij,mdi->mj", Jl, wr) * lm_free,
                                  Hll_diag=torch.einsum("mdij,md,mdik->mjk", Jl, w, Jl),
                                  cost=cost, n_active=active.sum())


def linearize_plain(problem, cam, segments, use_huber: bool, lm_free) -> gba_cuda.Linearization:
    """``local_ba._linearize`` of every slot, then ``normal_blocks``."""
    r, Jp, Jl, w, _, active, cost = _linearize(problem, cam, use_huber,
                                               torch.ones_like(problem.obs_mask))
    return normal_blocks(r, Jp, Jl, w, cost, active, segments, lm_free)


def cost_plain(problem, cam, use_huber: bool, per_slot: bool = False):
    """(cost, active count) of the problem as it stands; with ``per_slot``
    also each slot's chi² and active mask (M, D)."""
    *_, chi2, active, cost = _linearize(problem, cam, use_huber, torch.ones_like(problem.obs_mask))
    return (cost, active.sum(), chi2, active) if per_slot else (cost, active.sum())


def linearize(problem, cam, segments, use_huber: bool, lm_free) -> gba_cuda.Linearization:
    """The residuals' Jacobians and weights, the gradient, the diagonal
    blocks and the cost (``gba_cuda.Linearization``) of ``problem`` as it
    stands: ``gba_cuda.linearize`` on the card, ``linearize_plain`` on the
    CPU."""
    if problem.poses.device.type == "cpu":
        return linearize_plain(problem, cam, segments, use_huber, lm_free)
    return gba_cuda.linearize(problem, cam, segments, HUBER if use_huber else None, lm_free)


def lm_cost(problem, cam, use_huber: bool, per_slot: bool = False):
    """``cost_plain``'s values: ``gba_cuda.cost`` on the card (its sums in
    ``linearize``'s order), ``cost_plain`` on the CPU."""
    if problem.poses.device.type == "cpu":
        return cost_plain(problem, cam, use_huber, per_slot)
    return gba_cuda.cost(problem, cam, HUBER if use_huber else None, per_slot)


def ba_cost(problem: BAProblem, cam: PinholeCamera) -> torch.Tensor:
    """The plain (no Huber) cost of a problem as it stands: what
    ``GBAResult.cost`` reports after a solve."""
    return lm_cost(problem, cam, False)[0]


def lm_loop(problem, unknowns, free, lm_free, width: int, linearize, step, cost, final,
            iterations: int, cg_iters: int, huber_iters: int, span, all_reduce=None):
    """The LM outer loop with PCG inner solves of both whole-map solves
    (``global_bundle_adjust``: 6-wide poses; ``global_inertial_ba``: 15-wide
    states): damping from 1e-3, Huber weights while the iteration is below
    ``huber_iters``, the damped block-Jacobi preconditioner, ``cg_iters``
    PCG steps, the accept test (``lm_accept``), then the final pass and each
    observation's inlier class (active, χ² under the stereo / mono
    threshold).

    ``problem``: the solve's problem; its fields named in ``unknowns`` are
    what a step moves, each selected by ``torch.where`` after the accept
    test. ``free`` (K, 1) and ``lm_free`` (M, 1): the solved states and
    landmarks; ``width``: the state's size. The solve supplies
    ``linearize(problem, use_huber)`` → (cost, active count, (g_s, g_l) the
    masked gradient halves, (H_s, H_l) the (K, width²) or (K, width, width)
    and (M, 3, 3) diagonal blocks, ``hessian``), where ``hessian(lam_s,
    lam_l)`` gives ``H_apply_dot(v_s, v_l)`` = (H·v, v·H·v) for the damping
    vectors; ``step(problem, dx, dl)`` → the candidate; ``cost(problem,
    use_huber)`` → (cost, active count); ``final(problem)`` → (plain cost,
    χ² (M, D), active (M, D)). ``all_reduce``: adds the landmark half of
    each CG dot product over the ranks. Returns (problem, obs_inlier,
    cost)."""
    dtype, dev = problem.landmarks.dtype, problem.landmarks.device
    eye_s = torch.eye(width, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def dot(a, b):
        # the state half is replicated; the landmark half is this rank's
        (lm_half,) = _summed(all_reduce, torch.sum(a[1] * b[1]))
        return torch.sum(a[0] * b[0]) + lm_half

    lam = torch.full((), 1e-3, dtype=dtype, device=dev)
    floor_s, floor3 = 1e-7 * eye_s, 1e-7 * eye3
    for it in range(iterations):
        use_huber = it < huber_iters
        with span("gba.linearize"):
            # residuals, Jacobians, the gradient g = Jᵀ W r and the
            # block-Jacobi preconditioner's diagonal blocks
            cost_now, n_active, g, (H_s, H_l), hessian = linearize(problem, use_huber)

        with span("gba.precond"):
            # block-Jacobi preconditioner (damped diagonal blocks)
            H_s = H_s.reshape(free.shape[0], width, width)
            H_s_d = H_s + lam * _diag_part(H_s) + floor_s
            H_l_d = H_l + lam * _diag_part(H_l) + floor3
            Minv_s = torch.linalg.inv_ex(torch.where(free[..., None], H_s_d, eye_s))[0]
            Minv_l = torch.linalg.inv_ex(torch.where(lm_free[..., None], H_l_d, eye3))[0]
            lam_s = lam * torch.diagonal(H_s, dim1=-2, dim2=-1) + 1e-7    # (K, width)
            lam_l = lam * torch.diagonal(H_l, dim1=-2, dim2=-1) + 1e-7    # (M, 3)
            H_apply_dot = hessian(lam_s, lam_l)
            # inv_ex returns column-major blocks; the kernel reads them row-major
            precond = gba_cuda.BlockJacobi(Minv_s.contiguous(), Minv_l.contiguous(), free, lm_free)
            cg = pcg_start(precond, g, dot)
        dx, dl = pcg_steps(cg, H_apply_dot, precond, dot, cg_iters, span)

        with span("gba.accept"):
            new = step(problem, dx, dl)
            cost_new, n_active_new = cost(new, use_huber)
            accept, lam = lm_accept(cost_now, n_active, cost_new, n_active_new, lam)
            problem = problem._replace(**{
                f: torch.where(accept, getattr(new, f), getattr(problem, f)) for f in unknowns})

    with span("gba.final"):
        cost_now, chi2, active = final(problem)
        th = torch.where(problem.obs_ur >= 0, CHI2_STEREO, CHI2_MONO)
        return problem, active & (chi2 <= th), cost_now


def global_bundle_adjust(problem: BAProblem, cam: PinholeCamera, segments: PoseSegments,
                         iterations: int = 8,
                         cg_iters: int = 24, huber_iters: int = 5,
                         all_reduce: Optional[Callable[[torch.Tensor], None]] = None) -> GBAResult:
    """LM outer loop with PCG inner solves over the full (pose, landmark)
    state (``lm_loop``). Fixed/invalid poses and invalid landmarks are
    projected out of the Krylov space by masking.

    ``segments``: the ``PoseSegments`` of this problem's observation table
    (they serve every solve on that table; building them waits for the
    device once, so nothing in the solve does). ``all_reduce``: sums a flat
    tensor in place over the ranks of a landmark-sharded solve (the module
    docstring); ``problem`` then holds this rank's landmarks, and the
    result's cost is the sum over the ranks."""
    span = tracer(problem.poses.device)
    with span("gba.lm"):
        K = problem.poses.shape[0]
        pose_free = ((~problem.pose_fixed) & problem.pose_valid)[:, None]      # (K, 1)
        lm_free = problem.lm_valid[:, None]                                     # (M, 1)

        def linearize_at(P, use_huber):
            lin = linearize(P, cam, segments, use_huber, lm_free)
            cost, n_active, g_p, Hpp_diag = _summed(all_reduce, lin.cost, lin.n_active, lin.g_p,
                                                    lin.Hpp_diag)

            def hessian(lam_p, lam_l):
                # the tables from ``problem``: holding ``P`` would keep this
                # iteration's poses and landmarks alive through the next
                hv = gba_cuda.HessianProduct(lin.Jp, lin.Jl, lin.w, problem.obs_kf, segments,
                                             lam_l, lm_free)

                def H_apply_dot(v_p, v_l):
                    """(H·v, v·H·v); the landmark half of the dot travels with
                    the pose half of H·v."""
                    Hp, Hv_l, lm_half = hv(v_p, v_l)
                    Hp, lm_half = _summed(all_reduce, Hp, lm_half)
                    Hv_p = (Hp.reshape(K, 6) + lam_p * v_p) * pose_free
                    return (Hv_p, Hv_l), torch.sum(v_p * Hv_p) + lm_half
                return H_apply_dot

            g = (g_p.reshape(K, 6) * pose_free, lin.g_l)
            return cost, n_active, g, (Hpp_diag, lin.Hll_diag), hessian

        def step(P, dp, dl):
            poses, lms = gba_cuda.apply_step(dp, P.poses, dl, P.landmarks)
            return P._replace(poses=poses, landmarks=lms)

        def final(P):
            cost, _, chi2, active = lm_cost(P, cam, False, per_slot=True)
            (cost,) = _summed(all_reduce, cost)
            return cost, chi2, active

        P, inlier, cost = lm_loop(
            problem, ("poses", "landmarks"), pose_free, lm_free, 6, linearize_at, step,
            lambda P, use_huber: _summed(all_reduce, *lm_cost(P, cam, use_huber)), final,
            iterations, cg_iters, huber_iters, span, all_reduce)
        return GBAResult(poses=P.poses, landmarks=P.landmarks, obs_inlier=inlier, cost=cost)
