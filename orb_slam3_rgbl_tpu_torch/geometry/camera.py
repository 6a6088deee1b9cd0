"""Camera models: pinhole and Kannala-Brandt fisheye (counterpart of
``orb_slam3_rgbl_tpu.geometry.camera``; the reference's ``GeometricCamera``
hierarchy, ``Pinhole.cpp`` and ``KannalaBrandt8.cpp``).

Functions broadcast over leading axes of torch tensors; the ``np_*``
twins serve the host-side tracker. The ``geo_*`` functions dispatch on the
camera model, as the reference's reprojection edges project through
``GeometricCamera``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import lie, triangulation


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """fx, fy, cx, cy (+ optional radial-tangential distortion k1..k3,
    p1, p2). KITTI sequences are pre-rectified (all distortion zero)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 1241
    height: int = 376
    bf: float = 0.0         # stereo baseline × fx (Camera.bf)
    th_depth: float = 0.0   # close/far threshold = bf × ThDepth / fx

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))

    @property
    def K(self) -> np.ndarray:
        """The 3×3 intrinsic matrix, float32 on the host (``intrinsics``
        builds it on a device)."""
        return np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
                        np.float32)

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


@dataclasses.dataclass(frozen=True)
class KannalaBrandt8Camera:
    """Equidistant fisheye: r(θ) = θ + k0 θ³ + k1 θ⁵ + k2 θ⁷ + k3 θ⁹
    (``KannalaBrandt8.cpp``)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k0: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    width: int = 752
    height: int = 480
    bf: float = 0.0
    th_depth: float = 0.0


def is_fisheye(cam) -> bool:
    return isinstance(cam, KannalaBrandt8Camera)


def project(cam: PinholeCamera, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) → pixel coordinates (..., 2)."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    x = pts_cam[..., 0] * inv_z
    y = pts_cam[..., 1] * inv_z
    if cam.has_distortion:
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x, y = xd, yd
    return torch.stack([cam.fx * x + cam.cx, cam.fy * y + cam.cy], dim=-1)


def unproject(cam: PinholeCamera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) → unit-depth bearing (..., 3) (z = 1), the linear
    inverse of the distortion-free projection."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def undistort_points(cam: PinholeCamera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Distorted pixels (..., 2) → undistorted pixels (..., 2) under the same
    K (``Frame::UndistortKeyPoints``, ``cv::undistortPoints``): a fixed
    number of compensation steps of the radial-tangential model, on the
    tensor's device; the identity without distortion."""
    if not cam.has_distortion:
        return uv
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.stack([cam.fx * x + cam.cx, cam.fy * y + cam.cy], dim=-1)


def intrinsics(cam: PinholeCamera, dtype=torch.float32, device=None) -> torch.Tensor:
    """The 3×3 matrix K on ``device`` (default ``cuda``)."""
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                        dtype=dtype, device=resolve(device))


def project_jacobian(cam: PinholeCamera, pts_cam: torch.Tensor) -> torch.Tensor:
    """d(u,v)/d(X,Y,Z) for camera-frame points — (..., 2, 3),
    distortion-free form."""
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], dim=-1)
    row_v = torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def in_image(cam, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Boolean mask (...): the pixel lies inside the image, ``margin`` px
    from its border (the frustum gate of ``Frame::isInFrustum``)."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= margin) & (u < cam.width - margin) & (v >= margin) & (v < cam.height - margin)


def stereo_depth_from_disparity(cam: PinholeCamera, u_left: torch.Tensor,
                                u_right: torch.Tensor) -> torch.Tensor:
    """Depth from (pseudo-)stereo: z = bf / (uL − uR) (``Frame::UnprojectStereo``);
    a disparity under 1e-6 px counts as 1e-6."""
    disp = u_left - u_right
    return cam.bf / torch.where(disp.abs() < 1e-6, 1e-6, disp)


def virtual_right_u(cam: PinholeCamera, u: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """The pseudo-stereo right column uR = u − bf/z of the RGB-D and RGB-L
    paths (``Frame::ComputeStereoFromRGBD``); −1 where the depth is not
    positive."""
    valid = depth > 0
    return torch.where(valid, u - cam.bf / torch.where(valid, depth, 1.0), -1.0)


# ---------------------------------------------------------------------------
# Kannala-Brandt 8-parameter fisheye
# ---------------------------------------------------------------------------

KB8_NEWTON_STEPS = 10   # kb8_unproject's fixed trip count
KB8_CHI2 = 5.991        # the triangulation's reprojection gate (χ², 2 DoF, 95%)

def _kb8_r(cam: KannalaBrandt8Camera, theta):
    """The distortion polynomial r(θ) (tensors or numpy arrays)."""
    t2 = theta * theta
    return theta * (1.0 + t2 * (cam.k0 + t2 * (cam.k1 + t2 * (cam.k2 + t2 * cam.k3))))


def _kb8_dr(cam: KannalaBrandt8Camera, theta):
    """dr/dθ."""
    t2 = theta * theta
    return 1.0 + t2 * (3 * cam.k0 + t2 * (5 * cam.k1 + t2 * (7 * cam.k2 + t2 * 9 * cam.k3)))


def kb8_project(cam: KannalaBrandt8Camera, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) → pixels (..., 2); θ = atan2(r, z), so a
    point behind the camera lands past 90° of incidence."""
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    r = torch.sqrt(x * x + y * y + 1e-18)
    scale = _kb8_r(cam, torch.atan2(r, z)) / r
    return torch.stack([cam.fx * scale * x + cam.cx, cam.fy * scale * y + cam.cy], dim=-1)


def kb8_unproject(cam: KannalaBrandt8Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) → z = 1 bearings (..., 3): the polynomial inverted by
    ``KB8_NEWTON_STEPS`` Newton steps from θ = d (a fixed trip count, as in the JAX
    package; the reference stops on convergence), then tan(θ)/d. Past 90°
    of incidence tan(θ) < 0 and the bearing points the other way, as in
    the JAX package."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    d = torch.sqrt(mx * mx + my * my + 1e-18)
    theta = d
    for _ in range(KB8_NEWTON_STEPS):
        theta = theta - (_kb8_r(cam, theta) - d) / _kb8_dr(cam, theta)
    scale = torch.tan(theta) / d
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jacobian(cam: KannalaBrandt8Camera, pts_cam: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) ∂uv/∂pt in closed form (``KannalaBrandt8::projectJac``),
    with ``kb8_project``'s guard r² + 1e-18, so it is finite on the axis
    (where it tends to the pinhole's fx/z)."""
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    x2, y2 = x * x, y * y
    rr = x2 + y2 + 1e-18
    r = torch.sqrt(rr)
    theta = torch.atan2(r, z)
    d, dd = _kb8_r(cam, theta), _kb8_dr(cam, theta)
    f = rr + z * z
    a = dd * z / (rr * f)           # ∂θ/∂r · d'(θ) / r
    b = d / (r * rr)                # d / r³
    xy = x * y * (a - b)
    row_u = torch.stack([cam.fx * (a * x2 + b * (y2 + 1e-18)), cam.fx * xy,
                         -cam.fx * dd * x / f], dim=-1)
    row_v = torch.stack([cam.fy * xy, cam.fy * (a * y2 + b * (x2 + 1e-18)),
                         -cam.fy * dd * y / f], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def kb8_triangulate_matches(cam_l: KannalaBrandt8Camera, cam_r: KannalaBrandt8Camera,
                            T_lr: torch.Tensor, uv_l: torch.Tensor, uv_r: torch.Tensor,
                            sigma2_l: torch.Tensor, sigma2_r: torch.Tensor,
                            min_parallax_cos: float = 0.9998):
    """Stereo-fisheye triangulation (``KannalaBrandt8::TriangulateMatches``):
    both rays unprojected, a parallax gate, DLT in the left camera's frame,
    then cheirality and the reprojection χ² in both views.

    T_lr: (7,) pose of the right camera in the left frame (the reference's
    ``mTlr``); uv_l, uv_r (..., 2) matched pixels; sigma2_l, sigma2_r (...,)
    scale variances. Returns (X_l (..., 3) in the left frame, depth (...,),
    valid (...,) bool)."""
    r1 = kb8_unproject(cam_l, uv_l)
    r2 = kb8_unproject(cam_r, uv_r)
    r2_in_l = torch.einsum("ij,...j->...i", lie.quat_to_matrix(T_lr[:4]), r2)
    cosp = torch.sum(r1 * r2_in_l, dim=-1) / (
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2_in_l, dim=-1) + 1e-12)
    batch = uv_l.shape[:-1] + (7,)
    T_rl = lie.se3_inv(T_lr)
    X_l = triangulation.triangulate_dlt(
        r1, r2, lie.se3_identity(T_lr.dtype, T_lr.device).expand(batch), T_rl.expand(batch))
    X_r = lie.se3_apply(T_rl, X_l)
    e1 = kb8_project(cam_l, X_l) - uv_l
    e2 = kb8_project(cam_r, X_r) - uv_r
    chi1 = torch.sum(e1 * e1, dim=-1) / sigma2_l.clamp_min(1e-12)
    chi2 = torch.sum(e2 * e2, dim=-1) / sigma2_r.clamp_min(1e-12)
    z1 = X_l[..., 2]
    valid = ((cosp < min_parallax_cos) & (z1 > 0) & (X_r[..., 2] > 0)
             & (chi1 < KB8_CHI2) & (chi2 < KB8_CHI2))
    return X_l, z1, valid


def kb8_epipolar_constrain(cam1: KannalaBrandt8Camera, cam2: KannalaBrandt8Camera,
                           T_12: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                           sigma2: torch.Tensor) -> torch.Tensor:
    """Fisheye epipolar gate (``KannalaBrandt8::epipolarConstrain``): a
    match passes if it triangulates consistently. Epipolar lines are curves
    under fisheye distortion, so the pinhole point-to-line test does not
    apply. ``min_parallax_cos`` 2.0 makes the parallax gate always pass, as
    in the JAX package (1.0 would reject exactly parallel rays on rounding)."""
    _, _, valid = kb8_triangulate_matches(cam1, cam2, T_12, uv1, uv2, sigma2, sigma2,
                                          min_parallax_cos=2.0)
    return valid


# ---------------------------------------------------------------------------
# Dispatch on the camera model
# ---------------------------------------------------------------------------

def geo_project(cam, pts_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points → (..., 2) pixels, any camera model."""
    return kb8_project(cam, pts_cam) if is_fisheye(cam) else project(cam, pts_cam)


def geo_project_jacobian(cam, pts_cam: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) ∂uv/∂pt, any camera model."""
    if is_fisheye(cam):
        return kb8_project_jacobian(cam, pts_cam)
    return project_jacobian(cam, pts_cam)


def geo_unproject(cam, uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels → (..., 3) z = 1 bearings, any camera model."""
    return kb8_unproject(cam, uv) if is_fisheye(cam) else unproject(cam, uv)


def np_geo_unproject(cam, uv: np.ndarray) -> np.ndarray:
    """Host-side (numpy) z = 1 bearings, any camera model (``kb8_unproject``'s
    Newton steps for KB8)."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    if is_fisheye(cam):
        d = np.sqrt(mx * mx + my * my + 1e-18)
        theta = d
        for _ in range(KB8_NEWTON_STEPS):
            theta = theta - (_kb8_r(cam, theta) - d) / _kb8_dr(cam, theta)
        s = np.tan(theta) / d
        return np.stack([mx * s, my * s, np.ones_like(mx)], axis=-1)
    return np.stack([mx, my, np.ones_like(mx)], axis=-1)


def np_geo_project(cam, pts_cam: np.ndarray) -> np.ndarray:
    """Host-side (numpy) projection for the classic tracking ladder:
    (..., 3) camera-frame points → (..., 2) pixels, any camera model (a
    pinhole without distortion, as in the JAX package); pinhole points at
    z = 0 give finite garbage, not NaN."""
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    if is_fisheye(cam):
        r = np.sqrt(x * x + y * y + 1e-18)
        s = _kb8_r(cam, np.arctan2(r, z)) / r
        return np.stack([cam.fx * s * x + cam.cx, cam.fy * s * y + cam.cy], axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = cam.fx * x / z + cam.cx
        v = cam.fy * y / z + cam.cy
    return np.stack([np.nan_to_num(u), np.nan_to_num(v)], axis=-1)
