"""Stereo rectification (counterpart of ``orb_slam3_rgbl_tpu.geometry.rectify``;
the reference's ``Settings::precomputeRectificationMaps``): undistort and
row-align a calibrated stereo pair so that the stereo matcher can search
along rows.

The JAX package asks OpenCV for the maps (``stereoRectify`` with
``CALIB_ZERO_DISPARITY``, ``alpha=-1``, ``newImageSize`` = the image size,
then ``initUndistortRectifyMap``). The machine with the card has no OpenCV,
so the port computes the same thing itself, in float64 numpy, once at
set-up: Bouguet's rectification as OpenCV's ``cvStereoRectify`` does it
(half the relative rotation to each camera, then the rotation that takes the
baseline onto the x axis; the common focal length and principal point from
the undistorted image corners) and the radial-tangential
undistort-rectify maps. Per frame, ``remap`` warps both images on the device
by a bilinear gather (the counterpart of ``remap_jax``: out-of-image
neighbours read 0).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.config import SlamConfig
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera

UNDISTORT_ITERATIONS = 5   # cvUndistortPoints' fixed count (TermCriteria COUNT, 5)


@dataclasses.dataclass
class StereoRectifier:
    map_l: np.ndarray        # (H, W, 2) float32 source coordinates (x, y)
    map_r: np.ndarray
    cam_rect: PinholeCamera  # rectified pinhole intrinsics (+ bf)
    R1: np.ndarray = None    # (3, 3) left camera → rectified left camera (R_r1_u1)

    def __post_init__(self):
        self._dev_maps: dict = {}

    def _maps(self, device: torch.device):
        key = str(device)
        if key not in self._dev_maps:
            self._dev_maps[key] = tuple(torch.as_tensor(m, device=device)
                                        for m in (self.map_l, self.map_r))
        return self._dev_maps[key]

    def remap(self, img_l: torch.Tensor, img_r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both (H, W) f32 images rectified, on their device."""
        ml, mr = self._maps(img_l.device)
        return bilinear_gather(img_l, ml), bilinear_gather(img_r, mr)


def bilinear_gather(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``img`` (H, W) sampled at ``coords`` (..., 2) = (x, y) with bilinear
    weights; neighbours outside the image contribute 0. The arithmetic of
    ``jax.scipy.ndimage.map_coordinates(order=1, mode='constant')``: per
    neighbour the weight product (row weight × column weight) times the
    value, summed over (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    H, W = img.shape
    y, x = coords[..., 1], coords[..., 0]
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    out = None
    for yi, wy in ((y0, wy0), (y0 + 1.0, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1.0, wx1)):
            inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            v = img[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
            term = wy * wx * torch.where(inside, v, 0.0)
            out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# Bouguet's rectification, float64 numpy (OpenCV's cvStereoRectify)
# ---------------------------------------------------------------------------
def _rodrigues_to_matrix(r: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    k = r / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    c, s = np.cos(theta), np.sin(theta)
    return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * K


def _rodrigues_to_vector(R: np.ndarray) -> np.ndarray:
    """OpenCV's matrix → rotation-vector branch: the matrix is first made
    orthogonal by SVD; a rotation with sin θ < 1e-5 and cos θ > 0 is 0."""
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    rx, ry, rz = R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]
    s = np.sqrt((rx * rx + ry * ry + rz * rz) * 0.25)
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s >= 1e-5:
        return np.array([rx, ry, rz]) * (theta / (2.0 * s))
    if c > 0:
        return np.zeros(3)
    rx = np.sqrt(max((R[0, 0] + 1.0) * 0.5, 0.0))
    ry = np.sqrt(max((R[1, 1] + 1.0) * 0.5, 0.0)) * (-1.0 if R[0, 1] < 0 else 1.0)
    rz = np.sqrt(max((R[2, 2] + 1.0) * 0.5, 0.0)) * (-1.0 if R[0, 2] < 0 else 1.0)
    if abs(rx) < abs(ry) and abs(rx) < abs(rz) and (R[1, 2] > 0) != (ry * rz > 0):
        rz = -rz
    return np.array([rx, ry, rz]) * (theta / np.sqrt(rx * rx + ry * ry + rz * rz))


def _undistort_normalized(K: np.ndarray, D: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Pixels (n, 2) → normalized undistorted coordinates, by
    ``cvUndistortPoints``' fixed-point iteration (k1, k2, p1, p2, k3)."""
    k1, k2, p1, p2, k3 = D
    x0 = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y0 = (pts[:, 1] - K[1, 2]) / K[1, 1]
    x, y = x0.copy(), y0.copy()
    for _ in range(UNDISTORT_ITERATIONS):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return np.stack([x, y], axis=1)


def stereo_rectify(K1, D1, K2, D2, size: Tuple[int, int], R: np.ndarray, T: np.ndarray):
    """``cv2.stereoRectify(K1, D1, K2, D2, size, R, T,
    flags=CALIB_ZERO_DISPARITY, alpha=-1, newImageSize=size)`` →
    (R1, R2, P1, P2). ``R``, ``T``: the cam1 → cam2 point transform."""
    nx, ny = size
    r_r = _rodrigues_to_matrix(_rodrigues_to_vector(R) * -0.5)   # half the rotation each
    t = r_r @ T
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c, nt = t[idx], np.linalg.norm(t)
    if not nt > 0.0:
        raise ValueError("stereo_rectify: the two cameras share their centre")
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0.0:
        ww = ww * (np.arccos(abs(c) / nt) / nw)
    wR = _rodrigues_to_matrix(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T
    # common focal length (newImageSize = size: the ratio is 1/2)
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * 0.5
    corners = np.array([[0.0, 0.0], [nx - 1.0, 0.0], [0.0, ny - 1.0], [nx - 1.0, ny - 1.0]])
    cc = []
    for K, D, Rk in ((K1, D1, R1), (K2, D2, R2)):
        # float32 corners and points, as OpenCV's CvPoint2D32f buffers hold them
        xn = _undistort_normalized(K, D, corners.astype(np.float32).astype(np.float64))
        xn = xn.astype(np.float32).astype(np.float64)
        p = np.concatenate([xn, np.ones((4, 1))], axis=1) @ Rk.T
        proj = (fc_new * p[:, :2] / p[:, 2:3]).astype(np.float32).astype(np.float64)
        cc.append(((nx - 1) / 2.0 - proj[:, 0].mean(), (ny - 1) / 2.0 - proj[:, 1].mean()))
    # CALIB_ZERO_DISPARITY: one principal point for both
    cx = (cc[0][0] + cc[1][0]) * 0.5
    cy = (cc[0][1] + cc[1][1]) * 0.5
    P1 = np.array([[fc_new, 0.0, cx, 0.0], [0.0, fc_new, cy, 0.0], [0.0, 0.0, 1.0, 0.0]])
    P2 = P1.copy()
    P2[idx, 3] = t[idx] * fc_new   # baseline × focal length
    return R1, R2, P1, P2


def undistort_rectify_map(K, D, R, Knew, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.initUndistortRectifyMap(K, D, R, Knew, size, CV_32FC2)``: for
    each rectified pixel, the source pixel (x, y) in the distorted image."""
    nx, ny = size
    k1, k2, p1, p2, k3 = D
    iR = np.linalg.inv(Knew @ R)
    j, i = np.meshgrid(np.arange(nx, dtype=np.float64), np.arange(ny, dtype=np.float64))
    X = iR[0, 0] * j + iR[0, 1] * i + iR[0, 2]
    Y = iR[1, 0] * j + iR[1, 1] * i + iR[1, 2]
    Wh = iR[2, 0] * j + iR[2, 1] * i + iR[2, 2]
    x, y = X / Wh, Y / Wh
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2.0 * x * y
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = K[0, 0] * (x * kr + p1 * xy2 + p2 * (r2 + 2.0 * x2)) + K[0, 2]
    v = K[1, 1] * (y * kr + p1 * (r2 + 2.0 * y2) + p2 * xy2) + K[1, 2]
    return np.stack([u, v], axis=-1).astype(np.float32)


def build_rectifier(cfg: SlamConfig) -> StereoRectifier:
    """The maps and the rectified camera of ``cfg.camera`` + ``cfg.stereo``
    (host float64, once)."""
    st = cfg.stereo
    if st is None:
        raise ValueError("config has no stereo section")
    cam = cfg.camera
    K1 = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64)
    D1 = np.array([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3], np.float64)
    K2 = np.array([[st.fx, 0, st.cx], [0, st.fy, st.cy], [0, 0, 1]], np.float64)
    D2 = np.array([st.k1, st.k2, st.p1, st.p2, st.k3], np.float64)
    # T_c1_c2 is the pose of cam2 in cam1's frame; the rectification takes
    # the cam1 → cam2 point transform, its inverse
    T21 = np.linalg.inv(np.asarray(st.T_c1_c2, np.float64).reshape(4, 4))
    size = (cam.width, cam.height)
    R1, R2, P1, P2 = stereo_rectify(K1, D1, K2, D2, size, T21[:3, :3], T21[:3, 3])
    map_l = undistort_rectify_map(K1, D1, R1, P1[:3, :3], size)
    map_r = undistort_rectify_map(K2, D2, R2, P2[:3, :3], size)
    bf = float(abs(P2[0, 3]))   # P2[0, 3] = −fx · baseline
    cam_rect = dataclasses.replace(
        cam, fx=float(P1[0, 0]), fy=float(P1[1, 1]), cx=float(P1[0, 2]), cy=float(P1[1, 2]),
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=bf if bf > 0 else cam.bf)
    return StereoRectifier(map_l=map_l, map_r=map_r, cam_rect=cam_rect, R1=R1)
