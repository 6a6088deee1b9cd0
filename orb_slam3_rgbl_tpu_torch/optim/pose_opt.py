"""Motion-only bundle adjustment (counterpart of
``orb_slam3_rgbl_tpu.optim.pose_opt``; reference
``Optimizer::PoseOptimization``).

Levenberg-Marquardt on one SE3 pose with fixed landmarks, Huber-robust
mono (2D) and stereo (3D) reprojection residuals: 4 rounds × 5 iterations,
Huber in rounds 0-1, chi² re-classification (5.991 mono / 7.815 stereo)
after each round. All M observations are batched; each iteration reduces
to a 6×6 system. The accept decision is a ``torch.where`` on device
tensors, and no constant is copied from the host: nothing in the solve
waits for the card.

Pose convention: ``Tcw`` (world→camera), updated left-multiplicatively
``Tcw ← exp(δ) · Tcw`` with tangent ``δ = [rho, omega]``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import (
    PinholeCamera, geo_project, geo_project_jacobian, is_fisheye,
)

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = math.sqrt(CHI2_MONO)
HUBER_STEREO = math.sqrt(CHI2_STEREO)


class PoseObs(NamedTuple):
    """Batched observations of known landmarks from one frame."""

    Xw: torch.Tensor          # (M, 3) world landmark positions
    uv: torch.Tensor          # (M, 2) measured pixel coords
    u_right: torch.Tensor     # (M,)   pseudo-stereo column, −1 → mono obs
    inv_sigma2: torch.Tensor  # (M,) information weight (per octave)
    valid: torch.Tensor       # (M,) bool


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor         # (7,) optimized pose
    inliers: torch.Tensor     # (M,) bool final inlier classification
    n_inliers: torch.Tensor   # () int32
    chi2: torch.Tensor        # () final robust cost


def _residuals_and_jac(Tcw: torch.Tensor, obs: PoseObs, cam: PinholeCamera):
    """Per-observation residual [u, v, uR] (uR row zeroed for mono) and
    its (M, 3, 6) Jacobian w.r.t. the left-multiplicative SE3 tangent
    (``EdgeSE3ProjectXYZOnlyPose`` + ``EdgeStereoSE3ProjectXYZOnlyPose``).
    ``cam`` is any camera model; fisheye observations are always mono."""
    pc = lie.se3_apply(Tcw, obs.Xw)
    z = pc[:, 2]
    safe_z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    uv_hat = geo_project(cam, pc)
    u_hat, v_hat = uv_hat[:, 0], uv_hat[:, 1]
    is_stereo = obs.u_right >= 0
    if is_fisheye(cam):
        is_stereo = torch.zeros_like(is_stereo)
    ur_hat = u_hat - cam.bf / safe_z
    r = torch.stack([obs.uv[:, 0] - u_hat, obs.uv[:, 1] - v_hat,
                     torch.where(is_stereo, obs.u_right - ur_hat, 0.0)], dim=-1)

    # d(pc)/d(delta) for a left perturbation: [I | −[pc]×]  (M, 3, 6)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc = torch.cat([eye, -lie.so3_hat(pc)], dim=-1)
    Juv = geo_project_jacobian(cam, pc)                     # (M, 2, 3)
    # uR = u − bf/z → dUr/dpc = dU/dpc + bf/z² · e_z
    zeros = torch.zeros_like(z)
    dur = Juv[:, 0, :] + torch.stack([zeros, zeros, cam.bf / (safe_z * safe_z)], dim=-1)
    Jfull = torch.cat([Juv, dur[:, None, :]], dim=1)        # (M, 3, 3)
    J = -torch.bmm(Jfull, dpc)                              # residual = measured − predicted
    J = torch.cat([J[:, :2], torch.where(is_stereo[:, None], J[:, 2], 0.0)[:, None]], dim=1)
    return r, J, is_stereo, z > 1e-3


def _chi2(r, obs):
    return torch.sum(r * r, dim=-1) * obs.inv_sigma2


def _huber_weight(chi2, is_stereo, use_huber: bool):
    if not use_huber:
        return torch.ones_like(chi2)
    delta = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO)
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    return torch.where(e <= delta, 1.0, delta / e)


def _cost(Tcw, obs, cam, inlier, use_huber):
    r, J, is_stereo, depth_ok = _residuals_and_jac(Tcw, obs, cam)
    active = obs.valid & inlier & depth_ok
    chi2 = _chi2(r, obs)
    w_rob = _huber_weight(chi2, is_stereo, use_huber)
    cost = torch.sum(torch.where(active, torch.clamp_max(chi2, 1e6) * w_rob, 0.0))
    return r, J, active, w_rob, cost


def pose_optimize(Tcw0: torch.Tensor, obs: PoseObs, cam: PinholeCamera,
                  rounds: int = 4, iters_per_round: int = 5) -> PoseOptResult:
    """Run the 4-round robust LM pose solve (reference
    ``Optimizer.cc:1015-1103``): after each round every observation is
    re-classified by chi², outliers leave the next round's normal
    equations, and the Huber kernel is on for the first two rounds."""
    dtype, dev = Tcw0.dtype, Tcw0.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Tcw = Tcw0
    inlier = obs.valid
    for round_idx in range(rounds):
        use_huber = round_idx < 2
        lam = torch.full((), 1e-3, dtype=dtype, device=dev)
        for _ in range(iters_per_round):
            r, J, active, w_rob, cost = _cost(Tcw, obs, cam, inlier, use_huber)
            w = torch.where(active, obs.inv_sigma2 * w_rob, 0.0)
            # normal equations: H = Σ w Jᵀ J, b = Σ w Jᵀ r
            H = torch.einsum("m,mij,mik->jk", w, J, J)
            b = torch.einsum("m,mij,mi->j", w, J, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            # solve_ex skips the error check, which would sync with the host
            delta = -torch.linalg.solve_ex(Hd, b[:, None])[0][:, 0]
            T_new = lie.se3_normalize(lie.se3_mul(lie.se3_exp(delta), Tcw))
            _, _, active2, _, cost_new = _cost(T_new, obs, cam, inlier, use_huber)
            # diverged steps can empty the active set (all points behind
            # the camera / NaN) and collapse the cost to 0 — reject those
            accept = ((cost_new < cost) & torch.isfinite(cost_new)
                      & (2 * active2.sum() >= active.sum()))
            Tcw = torch.where(accept, T_new, Tcw)
            lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-9),
                              torch.clamp_max(lam * 4.0, 1e6))
        # re-classify
        r, _, is_stereo, depth_ok = _residuals_and_jac(Tcw, obs, cam)
        th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        inlier = obs.valid & depth_ok & (_chi2(r, obs) <= th)

    r, _, _, _ = _residuals_and_jac(Tcw, obs, cam)
    chi2 = torch.sum(torch.where(inlier, _chi2(r, obs), 0.0))
    return PoseOptResult(Tcw=Tcw, inliers=inlier,
                         n_inliers=inlier.sum().to(torch.int32), chi2=chi2)
