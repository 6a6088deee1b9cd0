"""Trajectory alignment and accuracy metrics (counterpart of
``orb_slam3_rgbl_tpu.geometry.align``).

Horn / Umeyama closed-form alignment with optional scale and the ATE RMSE
after it (the reference's ``evaluation/evaluate_ate_scale.py``), the
closed-form Sim3 of ``Sim3Solver::ComputeSim3``, and the KITTI-style
relative translation error. The functions follow their inputs' device and
dtype; numpy inputs become CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie


class Alignment(NamedTuple):
    q: torch.Tensor      # (4,) rotation model → data
    t: torch.Tensor      # (3,) translation
    s: torch.Tensor      # () scale
    rmse: torch.Tensor   # () RMSE after the alignment


def horn_align(model, data, weights: Optional[torch.Tensor] = None,
               with_scale: bool = False) -> Alignment:
    """Least-squares s·R·model + t ≈ data for (N, 3) corresponding points;
    ``weights`` (N,) non-negative (0 masks a point); ``with_scale`` solves
    the similarity instead of the rigid transform."""
    model, data = torch.as_tensor(model), torch.as_tensor(data)
    if weights is None:
        weights = torch.ones(model.shape[:-1], dtype=model.dtype, device=model.device)
    w = (weights / (weights.sum() + 1e-12))[..., None]
    mu_m = torch.sum(w * model, dim=0)
    mu_d = torch.sum(w * data, dim=0)
    mc = model - mu_m
    dc = data - mu_d
    # 3×3 cross-covariance; the determinant's sign rules out a reflection
    C = (w * dc).T @ mc
    U, S, Vt = torch.linalg.svd(C)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.cat([torch.ones_like(S[:2]), d[None]])
    R = U @ (D[:, None] * Vt)
    if with_scale:
        var_m = torch.sum(w[..., 0] * torch.sum(mc * mc, dim=-1))
        s = torch.sum(S * D) / (var_m + 1e-12)
    else:
        s = torch.ones((), dtype=model.dtype, device=model.device)
    t = mu_d - s * (R @ mu_m)
    err = s * mc @ R.T + mu_d - data
    rmse = torch.sqrt(torch.sum(w[..., 0] * torch.sum(err * err, dim=-1)))
    return Alignment(q=lie.matrix_to_quat(R), t=t, s=s, rmse=rmse)


def ate_rmse(gt_xyz, est_xyz, with_scale: bool = False) -> torch.Tensor:
    """Absolute trajectory error: RMSE of the estimated positions after
    their Horn alignment onto the ground truth."""
    return horn_align(est_xyz, gt_xyz, with_scale=with_scale).rmse


def sim3_from_correspondences(p1, p2, weights=None, fix_scale: bool = False) -> torch.Tensor:
    """(8,) Sim3 S21 with p2 ≈ S21 · p1 (``fix_scale``: the depth sensors'
    rigid case, ``mbFixScale``)."""
    a = horn_align(p1, p2, weights=weights, with_scale=not fix_scale)
    return torch.cat([a.q, a.t, a.s[None]], dim=-1)


def rpe_translation(gt_T, est_T, delta: int = 1) -> torch.Tensor:
    """Relative pose error, the RMS translation norm over frame pairs
    ``delta`` apart, of (N, 7) world-frame poses Twc."""
    gt_T, est_T = torch.as_tensor(gt_T), torch.as_tensor(est_T)
    rel_est = lie.se3_mul(lie.se3_inv(est_T[:-delta]), est_T[delta:])
    rel_gt = lie.se3_mul(lie.se3_inv(gt_T[:-delta]), gt_T[delta:])
    err = lie.se3_mul(lie.se3_inv(rel_gt), rel_est)
    return torch.sqrt(torch.mean(torch.sum(lie.se3_trans(err) ** 2, dim=-1)))
