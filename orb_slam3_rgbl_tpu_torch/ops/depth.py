"""LiDAR → dense depth map engine, the RGB-L novelty (counterpart of
``orb_slam3_rgbl_tpu.ops.depth``).

Project the raw cloud through ``P = K·T_velo→cam``, scatter-min into a
sparse depth image (collisions keep the closest point, deterministic under
parallel execution), then densify. Ported methods: ``InverseDilation``
(the KITTI default) and ``None``; ``AverageFiltering`` and
``NearestNeighborPixel`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def structuring_element(kind: str, ku: int, kv: int) -> np.ndarray:
    """Binary (kv, ku) structuring element: Rectangle | Cross | Ellipse |
    Diamond (diamond is square ku×ku, |dy|+|dx| ≤ ku//2 — the reference's
    hard-coded masks)."""
    kind = kind.lower()
    if kind == "diamond":
        r = ku // 2
        yy, xx = np.mgrid[-r: r + 1, -r: r + 1]
        return (np.abs(yy) + np.abs(xx) <= r).astype(np.bool_)
    if kind == "rectangle":
        return np.ones((kv, ku), dtype=np.bool_)
    if kind == "cross":
        m = np.zeros((kv, ku), dtype=np.bool_)
        m[kv // 2, :] = True
        m[:, ku // 2] = True
        return m
    if kind == "ellipse":
        ry, rx = kv / 2.0, ku / 2.0
        yy, xx = np.mgrid[0:kv, 0:ku]
        return (((yy - (kv - 1) / 2) / ry) ** 2 + ((xx - (ku - 1) / 2) / rx) ** 2 <= 1.0)
    raise ValueError(f"unknown structuring element kind: {kind}")


def lidar_projection_matrix(K: np.ndarray, T_velo_cam: np.ndarray) -> np.ndarray:
    """P(3×4) = K(3×3)·T_velo→cam(3×4), precomputed once."""
    K = np.asarray(K, dtype=np.float32).reshape(3, 3)
    T = np.asarray(T_velo_cam, dtype=np.float32).reshape(3, 4)
    return (K @ T).astype(np.float32)


def project_pointcloud(points: torch.Tensor, P: torch.Tensor, height: int, width: int,
                       min_dist: float = 5.0, max_dist: float = 200.0,
                       valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 3|4) LiDAR cloud → (height, width) f32 sparse depth, 0 where
    empty. Strict bounds u, v ∈ (0, size), distance gate d ∈ (min_dist,
    max_dist), truncating float→int pixel indexing; invalid points go to
    a dump slot past the image."""
    xyz = points[..., :3]
    homog = torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)   # (N, 4)
    proj = homog @ P.T                                                 # (N, 3)
    d = proj[..., 2]
    safe_d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    u = proj[..., 0] / safe_d
    v = proj[..., 1] / safe_d
    ok = (u > 0) & (v > 0) & (u < width) & (v < height) & (d > min_dist) & (d < max_dist)
    if valid_mask is not None:
        ok = ok & valid_mask
    ui = u.to(torch.int32).clamp(0, width - 1)
    vi = v.to(torch.int32).clamp(0, height - 1)
    flat = torch.where(ok, vi * width + ui, height * width).long()
    inf = float("inf")
    grid = torch.full((height * width + 1,), inf, dtype=torch.float32, device=points.device)
    grid = grid.scatter_reduce(0, flat, torch.where(ok, d, inf), reduce="amin",
                               include_self=True)
    depth = grid[: height * width]
    return torch.where(torch.isfinite(depth), depth, 0.0).reshape(height, width)


def _masked_window_max(img: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """Grayscale dilation of ``img`` by binary structuring element
    ``mask``: a max over the element's shifts, padding with -inf (a
    rectangle takes one max-pool)."""
    kv, ku = mask.shape
    cy, cx = kv // 2, ku // 2
    pad = (cx, ku - 1 - cx, cy, kv - 1 - cy)
    if mask.all():
        padded = F.pad(img[None, None], pad, value=float("-inf"))
        return F.max_pool2d(padded, (kv, ku), stride=1)[0, 0]
    H, W = img.shape
    padded = F.pad(img, pad, value=float("-inf"))
    out = torch.full_like(img, float("-inf"))
    for dy in range(kv):
        for dx in range(ku):
            if mask[dy, dx]:
                out = torch.maximum(out, padded[dy:dy + H, dx:dx + W])
    return out


def upsample_inverse_dilation(raw_depth: torch.Tensor, max_dist: float = 200.0,
                              kernel_kind: str = "Diamond", ku: int = 5,
                              kv: int = 7) -> torch.Tensor:
    """Nearest-surface-wins densification: invert depth about max_dist,
    grayscale-dilate with the structuring element, re-invert; pixels with
    no occupied neighbour inside the element stay 0 (reference
    ``DepthModule::Upsample_InverseDilation``)."""
    mask = structuring_element(kernel_kind, ku, kv)
    occupied = raw_depth > 0
    inv = torch.where(occupied, max_dist - raw_depth, float("-inf"))
    dilated = _masked_window_max(inv, mask)
    return torch.where(torch.isfinite(dilated), max_dist - dilated, 0.0)


def feature_depth(depth_map: torch.Tensor, kp_uv: torch.Tensor,
                  kp_uv_undist: torch.Tensor, bf: float):
    """Depth at keypoint pixels and the pseudo-stereo uRight: d =
    map[int(v), int(u)]; if d > 0 then depth = d, uRight = u − bf/d, else
    both −1 (reference ``DepthModule::GetFeatureDepthFromDepthMap``)."""
    H, W = depth_map.shape
    u = kp_uv[..., 0].to(torch.int32).clamp(0, W - 1).long()
    v = kp_uv[..., 1].to(torch.int32).clamp(0, H - 1).long()
    d = depth_map[v, u]
    valid = d > 0
    depth = torch.where(valid, d, -1.0)
    u_right = torch.where(valid, kp_uv_undist[..., 0] - bf / torch.where(valid, d, 1.0), -1.0)
    return depth, u_right


def compute_depth_from_pointcloud(points, P, kp_uv, kp_uv_undist, *, height: int,
                                  width: int, bf: float, method: str = "InverseDilation",
                                  min_dist: float = 5.0, max_dist: float = 200.0,
                                  dil_kind: str = "Diamond", dil_ku: int = 5,
                                  dil_kv: int = 7, valid_mask=None):
    """≡ ``DepthModule::CalculateDepthFromPcd``. Returns (depth_per_kp,
    u_right_per_kp, dense_depth_map)."""
    raw = project_pointcloud(points, P, height, width, min_dist, max_dist, valid_mask)
    if method == "None":
        dense = raw
    elif method == "InverseDilation":
        dense = upsample_inverse_dilation(raw, max_dist, dil_kind, dil_ku, dil_kv)
    elif method in ("AverageFiltering", "NearestNeighborPixel"):
        raise NotImplementedError(f"LiDAR upsampling method {method!r} is not ported yet")
    else:
        raise ValueError(f"unknown upsampling method: {method}")
    depth, u_right = feature_depth(dense, kp_uv, kp_uv_undist, bf)
    return depth, u_right, dense
