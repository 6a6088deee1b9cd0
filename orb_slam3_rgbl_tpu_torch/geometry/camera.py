"""Pinhole camera model (counterpart of ``orb_slam3_rgbl_tpu.geometry.camera``,
pinhole part only; the Kannala-Brandt fisheye waits for a later slice).

Functions broadcast over leading axes of torch tensors; the ``np_*``
twins serve the host-side tracker.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.device import resolve


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


def is_fisheye(cam) -> bool:
    """Only the pinhole model is ported; anything else is refused where a
    camera is consumed."""
    if not isinstance(cam, PinholeCamera):
        raise NotImplementedError(
            f"{type(cam).__name__} is not ported yet (pinhole only)")
    return False


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


def geo_project(cam, pts_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points → (..., 2) pixels."""
    is_fisheye(cam)
    return project(cam, pts_cam)


def geo_project_jacobian(cam, pts_cam: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) ∂uv/∂pt."""
    is_fisheye(cam)
    return project_jacobian(cam, pts_cam)


def geo_unproject(cam, uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels → (..., 3) z=1 bearing."""
    is_fisheye(cam)
    return unproject(cam, uv)


def np_geo_unproject(cam, uv: np.ndarray) -> np.ndarray:
    """Host-side (numpy) z=1 bearing."""
    is_fisheye(cam)
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    return np.stack([mx, my, np.ones_like(mx)], axis=-1)


def np_geo_project(cam, pts_cam: np.ndarray) -> np.ndarray:
    """Host-side (numpy) projection for the classic tracking ladder:
    (..., 3) camera-frame points → (..., 2) pixels, distortion-free (as in
    the JAX package); points at z = 0 give finite garbage, not NaN."""
    is_fisheye(cam)
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = cam.fx * x / z + cam.cx
        v = cam.fy * y / z + cam.cy
    return np.stack([np.nan_to_num(u), np.nan_to_num(v)], axis=-1)
