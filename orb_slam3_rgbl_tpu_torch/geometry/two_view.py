"""Monocular two-view initialization (counterpart of
``orb_slam3_rgbl_tpu.geometry.two_view``; reference
``TwoViewReconstruction.cc``): fundamental-matrix and homography RANSAC side
by side, model selection by score ratio, motion recovery (the four
decompositions of E told apart by cheirality and parallax) and the
triangulated initial map.

Both model families evaluate all hypotheses at once (batched 8-point and
4-point DLT solves, dense symmetric-transfer scoring); the winner's four
candidate motions are scored side by side. The function takes the real
matches; the minimal sets come from the caller's ``torch.Generator`` or from
``draws``. Eigenvectors and singular vectors are fixed only up to sign, so F,
H and E are too: every score and the chosen motion are invariant to it.

On the card ``torch.linalg.eigh`` and ``svd`` wait for the host. Initialization
is host-controlled anyway (the tracker reads ``success`` at once), so the
waits cost nothing the frame would not pay.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry import triangulation as tri
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera
from orb_slam3_rgbl_tpu_torch.optim.sim3 import first_argmax

SIGMA = 1.0
TH_F = 3.841   # chi2(1) 95% — fundamental line distance
TH_H = 5.991   # chi2(2) 95% — homography transfer
SCORE_F_BASE = 5.991


class TwoViewResult(NamedTuple):
    success: torch.Tensor     # () bool
    T21: torch.Tensor         # (7,) SE3 pose of view 2 w.r.t. view 1 (unit-norm t)
    points: torch.Tensor      # (P, 3) triangulated in view-1 frame
    is_good: torch.Tensor     # (P,) bool — inlier + positive depth + parallax
    used_homography: torch.Tensor  # () bool


def _normalize_points(uv, w=None):
    """Hartley normalization (batched over leading axes), optionally
    weighted: the points centred and scaled by their mean absolute
    deviation, and the 3×3 transform that does it."""
    if w is None:
        w = torch.ones_like(uv[..., 0])
    wsum = w.sum(dim=-1).clamp_min(1e-9)
    mean = (uv * w[..., None]).sum(dim=-2) / wsum[..., None]
    d = ((uv - mean[..., None, :]).abs() * w[..., None]).sum(dim=-2) / wsum[..., None]
    s = 1.0 / d.clamp_min(1e-8)
    zero, one = torch.zeros_like(s[..., 0]), torch.ones_like(s[..., 0])
    T = torch.stack([
        torch.stack([s[..., 0], zero, -mean[..., 0] * s[..., 0]], dim=-1),
        torch.stack([zero, s[..., 1], -mean[..., 1] * s[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1)], dim=-2)
    return (uv - mean[..., None, :]) * s[..., None, :], T


def _eight_point_F(uv1, uv2, w=None):
    """Normalized DLT + rank-2 projection (batched); optional per-row
    weights make this the all-inlier refit after hypothesis selection."""
    n1, T1 = _normalize_points(uv1, w)
    n2, T2 = _normalize_points(uv2, w)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)],
                    dim=-1)
    if w is not None:
        A = A * w[..., None]
    V = torch.linalg.eigh(A.transpose(-1, -2) @ A).eigenvectors
    F = V[..., :, 0].reshape(*V.shape[:-2], 3, 3)
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = U @ (S[..., :, None] * Vt)
    return T2.transpose(-1, -2) @ F @ T1


def _four_point_H(uv1, uv2):
    """(..., 4, 2) × (..., 4, 2) → H (..., 3, 3) via normalized DLT."""
    n1, T1 = _normalize_points(uv1)
    n2, T2 = _normalize_points(uv2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    r2 = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    V = torch.linalg.eigh(A.transpose(-1, -2) @ A).eigenvectors
    H = V[..., :, 0].reshape(*V.shape[:-2], 3, 3)
    return torch.linalg.inv(T2) @ H @ T1


def _homog(uv):
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def _score_F(F, uv1, uv2, valid):
    """Symmetric epipolar-line score (reference ``CheckFundamental``) of
    each F (..., 3, 3): (score (...,), inliers (..., P))."""
    x1, x2 = _homog(uv1), _homog(uv2)
    l2 = x1 @ F.transpose(-1, -2)      # line in image 2
    l1 = x2 @ F                        # line in image 1
    num = (x2 * l2).sum(dim=-1)
    d2_sq = num * num / (l2[..., 0] ** 2 + l2[..., 1] ** 2).clamp_min(1e-12)
    d1_sq = num * num / (l1[..., 0] ** 2 + l1[..., 1] ** 2).clamp_min(1e-12)
    inv_s2 = 1.0 / (SIGMA * SIGMA)
    c1 = d1_sq * inv_s2
    c2 = d2_sq * inv_s2
    s = (torch.where(c1 <= TH_F, SCORE_F_BASE - c1, 0.0)
         + torch.where(c2 <= TH_F, SCORE_F_BASE - c2, 0.0))
    inl = (c1 <= TH_F) & (c2 <= TH_F) & valid
    return torch.where(valid, s, 0.0).sum(dim=-1), inl


def _score_H(H, uv1, uv2, valid):
    """Symmetric transfer score (reference ``CheckHomography``) of each H."""
    x1, x2 = _homog(uv1), _homog(uv2)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = torch.linalg.inv(H + 1e-12 * eye)
    p12 = x1 @ H.transpose(-1, -2)
    p21 = x2 @ Hinv.transpose(-1, -2)
    p12 = p12[..., :2] / torch.where(p12[..., 2:].abs() < 1e-9, 1e-9, p12[..., 2:])
    p21 = p21[..., :2] / torch.where(p21[..., 2:].abs() < 1e-9, 1e-9, p21[..., 2:])
    d2 = ((uv2 - p12) ** 2).sum(dim=-1) / (SIGMA * SIGMA)
    d1 = ((uv1 - p21) ** 2).sum(dim=-1) / (SIGMA * SIGMA)
    s = torch.where(d1 <= TH_H, TH_H - d1, 0.0) + torch.where(d2 <= TH_H, TH_H - d2, 0.0)
    inl = (d1 <= TH_H) & (d2 <= TH_H) & valid
    return torch.where(valid, s, 0.0).sum(dim=-1), inl


def _decompose_E(E):
    """E → the 4 candidate (R, t) (Hartley-Zisserman)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U @ Vt))   # proper rotations
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = U[:, 2]
    t = t / torch.linalg.norm(t).clamp_min(1e-12)
    return (R1, t), (R1, -t), (R2, t), (R2, -t)


def two_view_draws(n: int, generator: torch.Generator, n_hypotheses: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The minimal sets of ``reconstruct_two_views``: (n_hypotheses, 8)
    for F and (n_hypotheses, 4) for H, uniform in [0, n)."""
    dev = generator.device
    return (torch.randint(0, n, (n_hypotheses, 8), generator=generator, device=dev),
            torch.randint(0, n, (n_hypotheses, 4), generator=generator, device=dev))


def reconstruct_two_views(uv1, uv2, valid, cam: PinholeCamera,
                          generator: Optional[torch.Generator] = None, n_hypotheses: int = 256,
                          draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> TwoViewResult:
    """Monocular initialization from matched pixels uv1, uv2 (P, 2) with
    ``valid`` (P,) (``TwoViewReconstruction::Reconstruct``): F and H race
    (homography at a score ratio SH/(SH+SF) > 0.4), then motion recovery.
    The homography branch reuses the essential decomposition of the
    refitted F; planar degeneracies fall to rejection by the quality gates.
    ``draws``: (idxF (H, 8), idxH (H, 4)) minimal sets; otherwise drawn
    from ``generator``."""
    P = uv1.shape[0]
    dev, dt = uv1.device, uv1.dtype
    if draws is None:
        if generator is None:
            raise ValueError("reconstruct_two_views needs the caller's torch.Generator "
                             "(or explicit draws)")
        draws = two_view_draws(P, generator, n_hypotheses)
    idxF, idxH = (torch.as_tensor(d).to(device=dev, dtype=torch.int64) for d in draws)

    Fs = _eight_point_F(uv1[idxF], uv2[idxF])
    Hs = _four_point_H(uv1[idxH], uv2[idxH])
    sF, inlF = _score_F(Fs, uv1, uv2, valid)
    sH, inlH = _score_H(Hs, uv1, uv2, valid)
    bF, bH = first_argmax(sF), first_argmax(sH)
    SF, SH = sF[bF], sH[bH]
    use_H = SH / (SH + SF).clamp_min(1e-9) > 0.4

    # refit on the consensus set, then once more on the refit's own inliers
    F1 = _eight_point_F(uv1, uv2, inlF[bF].to(dt))
    _, inlF1 = _score_F(F1, uv1, uv2, valid)
    Fbest = _eight_point_F(uv1, uv2, inlF1.to(dt))
    _, inlF2 = _score_F(Fbest, uv1, uv2, valid)
    inliers = torch.where(use_H, inlH[bH], inlF2)

    K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                     dtype=dt, device=dev)
    E = K.T @ Fbest @ K
    Kinv_T = torch.linalg.inv(K).T
    xn1 = _homog(uv1) @ Kinv_T
    xn2 = _homog(uv2) @ Kinv_T
    T1 = lie.se3_identity(dt, dev).expand(P, 7)

    counts, T21s, Xs, goods = [], [], [], []
    for R, t in _decompose_E(E):
        T21 = torch.cat([lie.matrix_to_quat(R), t])
        T2 = T21.expand(P, 7)
        X = tri.triangulate_midpoint(xn1, xn2, T1, T2)
        z2 = lie.se3_apply(T21, X)[:, 2]
        cosp = tri.parallax_cos(xn1, xn2, T1, T2)
        good = inliers & (X[:, 2] > 0) & (z2 > 0) & (cosp < 0.99998)
        counts.append(good.sum())
        T21s.append(T21)
        Xs.append(X)
        goods.append(good)
    counts = torch.stack(counts)
    best = first_argmax(counts)
    T21 = torch.stack(T21s)[best]
    X = torch.stack(Xs)[best]
    good = torch.stack(goods)[best]

    n_good = counts[best]
    n_inl = inliers.sum()
    second = torch.sort(counts).values[-2]
    # minimum-parallax gate (reference CheckRT: the 50th smallest
    # cos-parallax, or the last, must be above 1°): rejects pure rotation
    cosp_best = tri.parallax_cos(xn1, xn2, T1, T21.expand(P, 7))
    sorted_cosp = torch.sort(torch.where(good, cosp_best, 2.0)).values
    idx50 = torch.clamp((n_good - 1).clamp_min(0), max=50)
    parallax_ok = sorted_cosp[idx50] < 0.999848   # cos(1.0°)
    success = ((n_good >= 50) & (n_good > 0.75 * n_inl) & (second < 0.7 * n_good)
               & parallax_ok)
    return TwoViewResult(success=success, T21=T21, points=X, is_good=good,
                         used_homography=use_H)
