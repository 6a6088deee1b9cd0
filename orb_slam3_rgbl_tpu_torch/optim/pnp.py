"""Pose recovery from scratch for relocalization (counterpart of
``orb_slam3_rgbl_tpu.optim.pnp``; stands in for the reference's
``MLPnPsolver`` RANSAC).

Depth sensors give the query features their 3D, so hypotheses come from
closed-form 3-point rigid alignment (camera-frame points ↔ world
landmarks); the monocular sensor has no query depth, and its hypotheses
are 6-point DLT poses (2D ↔ 3D). All H hypotheses are evaluated at once;
inliers are gated by reprojection error (chi2 5.991·σ²). The functions
take the real correspondences; minimal sets come from the caller's
``torch.Generator`` or from ``draws``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.optim.sim3 import _horn_sim3_3pt, first_argmax, minimal_sets


class PnPResult(NamedTuple):
    Tcw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def rigid_pnp_hypotheses(p_cam, X_w, uv, sigma2, valid, cam: PinholeCamera, idx: torch.Tensor):
    """Every hypothesis of the minimal sets ``idx`` (H, 3): the poses
    (H, 7), their inlier masks (H, P) and inlier counts (H,)."""
    # Tcw candidates: p_cam ≈ T · X_w (rigid)
    Tcw = _horn_sim3_3pt(p_cam[idx], X_w[idx], fix_scale=True)[:, :7]   # (H, 7)
    pc = lie.se3_apply(Tcw[:, None, :], X_w[None])                      # (H, P, 3)
    z = torch.where(pc[..., 2].abs() < 1e-6, 1e-6, pc[..., 2])
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    e2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inl = (e2 < 5.991 * sigma2[None]) & (pc[..., 2] > 0.1) & valid[None]
    return Tcw, inl, inl.sum(dim=1)


def rigid_pnp_ransac(p_cam, X_w, uv, sigma2, valid, cam: PinholeCamera,
                     generator: Optional[torch.Generator] = None, n_hypotheses: int = 256,
                     draws: Optional[torch.Tensor] = None) -> PnPResult:
    """p_cam (P, 3): query-feature positions in the camera frame (from
    depth); X_w (P, 3): matched landmark world positions; uv (P, 2) query
    keypoints; sigma2 (P,); valid (P,) bool. Minimal sets come from the
    caller's ``generator`` or from ``draws`` (H, 3); the first hypothesis
    with the most inliers wins."""
    idx = minimal_sets(valid, n_hypotheses, generator, draws)
    Tcw, inl, counts = rigid_pnp_hypotheses(p_cam, X_w, uv, sigma2, valid, cam, idx)
    best = first_argmax(counts)
    return PnPResult(Tcw=lie.se3_normalize(Tcw[best]), inliers=inl[best],
                     n_inliers=counts[best].to(torch.int32))


def _dlt_pnp_6pt(Xw: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Minimal 6-point DLT poses, batched: world points (..., 6, 3) and
    normalized image coordinates (..., 6, 2) → Tcw (..., 7). The projective
    3×4 solution (the right singular vector of the smallest singular value)
    takes the sign that puts most of the set in front of the camera, and its
    rotation block is projected onto SO(3) (orthogonal Procrustes)."""
    ones = torch.ones_like(Xw[..., :1])
    zer = torch.zeros_like(Xw[..., :1]).expand(*Xw.shape[:-1], 4)
    Xh = torch.cat([Xw, ones], dim=-1)                                   # (..., 6, 4)
    r1 = torch.cat([Xh, zer, -xn[..., :1] * Xh], dim=-1)                 # (..., 6, 12)
    r2 = torch.cat([zer, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                                      # (..., 12, 12)
    Vh = torch.linalg.svd(A, full_matrices=True).Vh
    Pm = Vh[..., -1, :].reshape(*Xw.shape[:-2], 3, 4)
    depths = torch.einsum("...nk,...k->...n", Xh, Pm[..., 2, :])
    Pm = Pm * torch.sign(torch.sign(depths).sum(dim=-1) + 0.5)[..., None, None]
    U, S, Vt2 = torch.linalg.svd(Pm[..., :3])
    det = torch.linalg.det(U @ Vt2)
    D = torch.cat([torch.ones_like(S[..., :2]), det[..., None]], dim=-1)
    R = U @ (D[..., :, None] * Vt2)
    t = Pm[..., 3] / S.mean(dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.cat([lie.matrix_to_quat(R), t], dim=-1)


def dlt_pnp_hypotheses(X_w, uv, sigma2, valid, cam: PinholeCamera, idx: torch.Tensor):
    """Every DLT hypothesis of the minimal sets ``idx`` (H, 6): the poses
    (H, 7), their inlier masks (H, P) and inlier counts (H,)."""
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], dim=1)
    Tcw = _dlt_pnp_6pt(X_w[idx], xn[idx])                               # (H, 7)
    pc = lie.se3_apply(Tcw[:, None, :], X_w[None])                      # (H, P, 3)
    z = torch.where(pc[..., 2].abs() < 1e-6, 1e-6, pc[..., 2])
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    e2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inl = (e2 < 5.991 * sigma2[None]) & (pc[..., 2] > 0.05) & valid[None]
    return Tcw, inl, inl.sum(dim=1)


def dlt_pnp_ransac(X_w, uv, sigma2, valid, cam: PinholeCamera,
                   generator: Optional[torch.Generator] = None, n_hypotheses: int = 512,
                   draws: Optional[torch.Tensor] = None) -> PnPResult:
    """2D → 3D PnP RANSAC for the sensor without query depth (monocular
    relocalization): X_w (P, 3) matched landmark world positions, uv (P, 2)
    query keypoints, sigma2 (P,), valid (P,) bool. Minimal sets of 6 come
    from ``generator`` or from ``draws`` (H, 6); the first hypothesis with
    the most inliers wins."""
    idx = minimal_sets(valid, n_hypotheses, generator, draws, size=6)
    Tcw, inl, counts = dlt_pnp_hypotheses(X_w, uv, sigma2, valid, cam, idx)
    best = first_argmax(counts)
    return PnPResult(Tcw=lie.se3_normalize(Tcw[best]), inliers=inl[best],
                     n_inliers=counts[best].to(torch.int32))
