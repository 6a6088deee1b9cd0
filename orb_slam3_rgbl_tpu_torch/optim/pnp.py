"""Pose recovery from scratch for relocalization (counterpart of
``orb_slam3_rgbl_tpu.optim.pnp``; stands in for the reference's
``MLPnPsolver`` RANSAC).

Depth sensors give the query features their 3D, so hypotheses come from
closed-form 3-point rigid alignment (camera-frame points ↔ world
landmarks), all H at once; inliers are gated by reprojection error
(chi2 5.991·σ²). Only this rigid solver is ported: the monocular DLT
solver belongs to ROADMAP Queue 1 item 14.
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
