"""Whole-map visual-inertial bundle adjustment: matrix-free preconditioned
CG over 15-wide states (reference ``Optimizer::FullInertialBA``, which the
loop closer runs after a correction on an inertial map whose IMU is
initialized, ``LoopClosing.cc:2284-2287``).

``inertial_ba.vi_bundle_adjust`` eliminates the landmarks into a dense
(15K)² system through (M, K, 15, 3) products: O(M·K) memory, no good for a
whole map. Here, as in ``global_ba``, the normal equations are never
formed. The unknowns are one state a keyframe, [pose(6), vel(3), bg(3),
ba(3)] with the body pose's tangent on the left (``inertial_ba``), and 3 a
landmark; the first keyframe's state is fixed whole. Each CG step applies

    H·v = Jᵀ W (J v) over the observations (columns 0:6 of each state)
        + Σ pairs J_pᵀ W_p (J_p v) over the preintegration and bias-walk
          factors of each consecutive pair (15 × 30 each)
        + λ D v

through ``ops/gba_cuda``: ``HessianProduct`` (``gba_hv`` and
``gba_pose_sum``, the visual solve's kernels, reading the pose columns of
the 15-wide vector), then ``PairProduct`` (``gba_pair_hv``: the pairs' half
added to the visual pose sums, the damping, the state mask and v·H·v in one
launch), ``BlockJacobi`` (15×15 state and 3×3 landmark blocks) and
``cg_direction``. The pairs' sums onto their states go through
``pair_segments``, global_ba's ``PoseSegments`` over the pairs' endpoints,
built once, so two solves of one problem give the same bits; nothing in the
solve waits for the device.

The residuals are ``inertial_ba``'s: the visual ones through
``_visual_linearize`` (T_cw = T_cb · Twb⁻¹), their gradient and blocks
through ``global_ba.normal_blocks``, the pairs' nine preintegration and six
bias-walk residuals with their Jacobians from ``_inertial_linearize``
(forward-mode autodiff), weighted by ``_pair_weights``. The LM loop is
``global_ba.lm_loop``, the visual solve's: damping from 1e-3, × 0.4 on an
accepted step (≥ 1e-8), × 5 on a rejected one (≤ 1e4); a step is kept where
the total cost is lower, finite, and keeps half the active observations;
Huber weights while the iteration is below ``huber_iters``. This module
supplies the linearization, H·v, step and cost of the 15-wide states.

Under ``torch.profiler`` the spans are ``global_ba``'s (``gba.segments``,
``gba.lm`` ⊃ ``gba.linearize``, ``gba.precond``, ``gba.cg_step``,
``gba.accept``; ``gba.final``), with ``gba.imu_linearize`` inside
``gba.linearize`` around the pairs' residuals and Jacobians; the 15×15
state and 3×3 landmark blocks are summed in ``gba.linearize``, as the
visual solve's are.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.ops import gba_cuda
from orb_slam3_rgbl_tpu_torch.optim.global_ba import PoseSegments, lm_loop, normal_blocks
from orb_slam3_rgbl_tpu_torch.optim.inertial_ba import (S, VIBAProblem, VIBAResult,
                                                        _apply_state_delta, _inertial_cost,
                                                        _inertial_linearize, _visual_linearize)
from orb_slam3_rgbl_tpu_torch.utils.profiling import tracer


UNKNOWNS = ("Twb", "vel", "bg", "ba", "landmarks")   # the fields a step moves


def pair_segments(pair_i: torch.Tensor, pair_j: torch.Tensor, n_states: int) -> PoseSegments:
    """The pairs of each state as ``PoseSegments`` over the (P, 2) table of
    endpoints: a (K, L) table of entries 2·pair + side (side 0 the pair's
    first state, 1 its second) in entry order, unused slots 2P; its ``sum``
    takes (2P, C) per-entry values."""
    ends = torch.stack([pair_i, pair_j], dim=1)
    return PoseSegments(ends, torch.ones_like(ends, dtype=torch.bool), n_states)


class VISegments(NamedTuple):
    """The fixed sum tables of one problem: its observations' per-pose
    table and its pairs' per-state table."""
    obs: PoseSegments
    pairs: PoseSegments


def make_segments(problem: VIBAProblem) -> VISegments:
    """Both tables of ``problem`` (each sized by one wait for the device)."""
    K = problem.Twb.shape[0]
    return VISegments(PoseSegments(problem.obs_kf, problem.obs_mask, K),
                      pair_segments(problem.pair_i, problem.pair_j, K))


def vi_cost(problem: VIBAProblem, cam: PinholeCamera) -> torch.Tensor:
    """The plain (no Huber) visual and inertial cost of a problem as it
    stands: what ``VIBAResult.cost`` reports after a solve."""
    return _cost(problem, cam, False, torch.ones_like(problem.obs_mask))[0]


def _cost(P: VIBAProblem, cam, use_huber: bool, all_obs):
    """(visual and inertial cost, χ² (M, D), active (M, D)) of ``P``;
    ``all_obs`` an (M, D) mask of ones."""
    *_, chi2, active, cost_v = _visual_linearize(P, cam, use_huber, all_obs)
    return cost_v + _inertial_cost(P), chi2, active


def _per_side(J_in: torch.Tensor) -> torch.Tensor:
    """(P, 15, 30) pair Jacobians → (2P, 15, 15): entry 2p + side the
    Jacobian in that side's state."""
    P = J_in.shape[0]
    return J_in.reshape(P, S, 2, S).permute(0, 2, 1, 3).reshape(2 * P, S, S)


def global_inertial_bundle_adjust(problem: VIBAProblem, cam: PinholeCamera,
                                  segments: VISegments, iterations: int = 7,
                                  cg_iters: int = 64, huber_iters: int = 7) -> VIBAResult:
    """LM outer loop with PCG inner solves over every keyframe's 15-wide
    state and every landmark (the module docstring). ``segments``:
    ``make_segments(problem)``, built before the solve. Returns the states,
    landmarks, each observation's inlier class (active with χ² under the
    stereo / mono threshold) and the plain cost of the result."""
    span = tracer(problem.Twb.device)
    with span("gba.lm"):
        K = problem.Twb.shape[0]
        all_obs = torch.ones_like(problem.obs_mask)
        state_free = ((~problem.state_fixed) & problem.state_valid)[:, None]   # (K, 1)
        lm_free = problem.lm_valid[:, None]                                     # (M, 1)
        obs_seg, pair_seg = segments

        def linearize(P, use_huber):
            r, Jp, Jl, w, _, active, cost_v = _visual_linearize(P, cam, use_huber, all_obs)
            with span("gba.imu_linearize"):
                r_in, J_in, w_in, cost_i = _inertial_linearize(P)
            vis = normal_blocks(r, Jp, Jl, w, cost_v + cost_i, active, obs_seg, lm_free)
            # the pairs' gradient and diagonal blocks, entry by entry
            Js = _per_side(J_in)                                                # (2P, 15, 15)
            ws = w_in.repeat_interleave(2, dim=0)                               # (2P, 15)
            wr_in = (w_in * r_in).repeat_interleave(2, dim=0)
            g_pair = pair_seg.sum(torch.einsum("eij,ei->ej", Js, wr_in))
            H_pair = pair_seg.sum(torch.einsum("eij,ei,eik->ejk", Js, ws, Js).reshape(-1, S * S))
            g_s = (F.pad(vis.g_p, (0, S - 6)) + g_pair) * state_free
            H_s = (F.pad(vis.Hpp_diag.reshape(K, 6, 6), (0, S - 6, 0, S - 6))
                   + H_pair.reshape(K, S, S))

            def hessian(lam_s, lam_l):
                # the tables from ``problem``, not ``P`` (global_bundle_adjust's note)
                hv = gba_cuda.HessianProduct(Jp.contiguous(), Jl.contiguous(), w.contiguous(),
                                             problem.obs_kf, obs_seg, lam_l, lm_free)
                pair_hv = gba_cuda.PairProduct(J_in.contiguous(), w_in.contiguous(),
                                               problem.pair_i, problem.pair_j, pair_seg.table,
                                               lam_s.contiguous(), state_free)

                def H_apply_dot(v_s, v_l):
                    """(H·v, v·H·v): the visual pose sums and landmark half,
                    then the pairs' half, the damping and the dot in one
                    launch."""
                    Hp, Hv_l, lm_half = hv(v_s, v_l)
                    Hv_s, pAp = pair_hv(Hp, v_s, lm_half)
                    return (Hv_s, Hv_l), pAp
                return H_apply_dot

            return vis.cost, vis.n_active, (g_s, vis.g_l), (H_s, vis.Hll_diag), hessian

        def accept_cost(P, use_huber):
            cost, _, active = _cost(P, cam, use_huber, all_obs)
            return cost, active.sum()

        P, inlier, cost = lm_loop(
            problem, UNKNOWNS, state_free, lm_free, S, linearize,
            lambda P, dx, dl: _apply_state_delta(P, dx)._replace(landmarks=P.landmarks + dl),
            accept_cost, lambda P: _cost(P, cam, False, all_obs), iterations, cg_iters,
            huber_iters, span)
        return VIBAResult(*(getattr(P, f) for f in UNKNOWNS), obs_inlier=inlier, cost=cost)
