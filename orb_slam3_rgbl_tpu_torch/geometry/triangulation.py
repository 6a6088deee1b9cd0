"""Two-view triangulation primitives (counterpart of
``orb_slam3_rgbl_tpu.geometry.triangulation``; reference
``GeometricTools::Triangulate`` and ``GeometricTools::ComputeF12``).

All functions are batched: leading axes broadcast. The bearing-side
epipolar helpers of the fisheye model wait for that camera's slice.
"""

from __future__ import annotations

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie


def _dlt_rows(xn1, xn2, Tc1w, Tc2w) -> torch.Tensor:
    """The (..., 4, 4) DLT system x̂ = P X of two views, rows scaled to unit
    norm (the normal equations square the condition number; unit rows keep
    it tame in f32)."""
    P1 = lie.se3_to_matrix(Tc1w)[..., :3, :]
    P2 = lie.se3_to_matrix(Tc2w)[..., :3, :]
    rows = []
    for xn, P in ((xn1, P1), (xn2, P2)):
        x, y = xn[..., 0:1], xn[..., 1:2]
        rows.append(x * P[..., 2, :] - P[..., 0, :])
        rows.append(y * P[..., 2, :] - P[..., 1, :])
    A = torch.stack(rows, dim=-2)
    return A / torch.linalg.norm(A, dim=-1, keepdim=True).clamp_min(1e-12)


def triangulate_dlt(xn1, xn2, Tc1w, Tc2w) -> torch.Tensor:
    """DLT triangulation of normalized bearings.

    xn1, xn2: (..., 3) normalized (z = 1) coordinates in cameras 1 and 2.
    Tc1w, Tc2w: (..., 7) SE3 world→camera poses.
    Returns (..., 3) world points: the eigenvector of AᵀA with the
    smallest eigenvalue, dehomogenized."""
    A = _dlt_rows(xn1, xn2, Tc1w, Tc2w)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    X = V[..., :, 0]                      # ascending eigenvalues → first column
    w = X[..., 3]
    return X[..., :3] / torch.where(w.abs() < 1e-12, 1e-12, w)[..., None]


def triangulate_fast(xn1, xn2, Tc1w, Tc2w) -> torch.Tensor:
    """Inhomogeneous DLT: fix the homogeneous coordinate w = 1 and solve
    the 4×3 system by closed-form 3×3 normal equations (adjugate inverse).
    Valid for finite points, the set that survives the mapping plane's
    parallax, cheirality and reprojection gates."""
    A = _dlt_rows(xn1, xn2, Tc1w, Tc2w)
    A3, a4 = A[..., :3], A[..., 3]
    M = A3.transpose(-1, -2) @ A3                           # (..., 3, 3)
    b = -torch.einsum("...ij,...i->...j", A3, a4)
    c00 = M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1]
    c01 = M[..., 0, 2] * M[..., 2, 1] - M[..., 0, 1] * M[..., 2, 2]
    c02 = M[..., 0, 1] * M[..., 1, 2] - M[..., 0, 2] * M[..., 1, 1]
    c10 = M[..., 1, 2] * M[..., 2, 0] - M[..., 1, 0] * M[..., 2, 2]
    c11 = M[..., 0, 0] * M[..., 2, 2] - M[..., 0, 2] * M[..., 2, 0]
    c12 = M[..., 0, 2] * M[..., 1, 0] - M[..., 0, 0] * M[..., 1, 2]
    c20 = M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]
    c21 = M[..., 0, 1] * M[..., 2, 0] - M[..., 0, 0] * M[..., 2, 1]
    c22 = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    det = M[..., 0, 0] * c00 + M[..., 0, 1] * c10 + M[..., 0, 2] * c20
    inv = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    inv = inv / torch.where(det.abs() < 1e-20, 1e-20, det)[..., None, None]
    return torch.einsum("...ij,...j->...i", inv, b)


def _world_rays(xn1, xn2, Tc1w, Tc2w):
    """Camera centres and unit ray directions of the two bearings in the
    world frame."""
    Twc1 = lie.se3_inv(Tc1w)
    Twc2 = lie.se3_inv(Tc2w)
    d1 = lie.quat_rotate(Twc1[..., :4], xn1)
    d2 = lie.quat_rotate(Twc2[..., :4], xn2)
    d1 = d1 / torch.linalg.norm(d1, dim=-1, keepdim=True)
    d2 = d2 / torch.linalg.norm(d2, dim=-1, keepdim=True)
    return lie.se3_trans(Twc1), lie.se3_trans(Twc2), d1, d2


def triangulate_midpoint(xn1, xn2, Tc1w, Tc2w) -> torch.Tensor:
    """Closed-form midpoint triangulation (cheaper than DLT; candidate
    scoring). Returns (..., 3) world points."""
    c1, c2, d1, d2 = _world_rays(xn1, xn2, Tc1w, Tc2w)
    b = c2 - c1
    d12 = torch.sum(d1 * d2, dim=-1)
    denom = 1.0 - d12 * d12
    denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
    bd1 = torch.sum(b * d1, dim=-1)
    bd2 = torch.sum(b * d2, dim=-1)
    t1 = (bd1 - bd2 * d12) / denom
    t2 = (bd1 * d12 - bd2) / denom
    return 0.5 * ((c1 + t1[..., None] * d1) + (c2 + t2[..., None] * d2))


def parallax_cos(xn1, xn2, Tc1w, Tc2w) -> torch.Tensor:
    """Cosine of the ray parallax angle between the two observations, the
    acceptance gate of ``LocalMapping::CreateNewMapPoints`` (cosParallax <
    0.9998)."""
    _, _, r1, r2 = _world_rays(xn1, xn2, Tc1w, Tc2w)
    return torch.sum(r1 * r2, dim=-1)


def fundamental_from_poses(K1, K2, Tc1w, Tc2w) -> torch.Tensor:
    """F12 such that x1ᵀ F12 x2 = 0 (``GeometricTools::ComputeF12``), for
    epipolar-constrained triangulation matching."""
    T12 = lie.se3_mul(Tc1w, lie.se3_inv(Tc2w))              # camera 2 → camera 1
    R12 = lie.quat_to_matrix(T12[..., :4])
    E = lie.so3_hat(lie.se3_trans(T12)) @ R12
    # inv_ex: no error check, which would wait for the card
    K1inv = torch.linalg.inv_ex(K1)[0]
    K2inv = torch.linalg.inv_ex(K2)[0]
    return K1inv.transpose(-1, -2) @ E @ K2inv


def epipolar_distance_sq(F12, uv1, uv2) -> torch.Tensor:
    """Squared distance of uv2 from the epipolar line F12ᵀ·uv1, the gate of
    ``ORBmatcher::SearchForTriangulation`` (dist² < 3.84 σ²)."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[..., :1])], dim=-1)
    line = torch.einsum("...ij,...j->...i", F12.transpose(-1, -2), x1)
    num = torch.einsum("...i,...i->...", x2, line)
    den = line[..., 0] ** 2 + line[..., 1] ** 2
    return num * num / torch.where(den < 1e-12, 1e-12, den)
