"""LiDAR → dense depth map engine, the RGB-L novelty (counterpart of
``orb_slam3_rgbl_tpu.ops.depth``).

Project the raw cloud through ``P = K·T_velo→cam``, scatter-min into a
sparse depth image (collisions keep the closest point, deterministic under
parallel execution), then densify by one of the paper's three methods
(``LiDAR.Method``): ``InverseDilation`` (the KITTI default),
``AverageFiltering`` (a normalized box filter after a Diamond-3
pre-dilation) or ``NearestNeighborPixel`` (per keypoint, the nearest
occupied pixel's depth within a search radius); ``None`` keeps the raw
projection.
"""

from __future__ import annotations

import math

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


def _window_sum(img: torch.Tensor, k: int) -> torch.Tensor:
    """Sum over the k×k window centred (for odd k) on each pixel, zero
    padding."""
    c = k // 2
    padded = F.pad(img[None, None], (c, k - 1 - c, c, k - 1 - c))
    return F.avg_pool2d(padded, k, stride=1, divisor_override=1)[0, 0]


def upsample_average_filtering(raw_depth: torch.Tensor, kernel_size: int = 5,
                               pre_dilate: bool = True, pre_kind: str = "Diamond",
                               pre_size: int = 3, max_dist: float = 200.0) -> torch.Tensor:
    """Normalized box filter, box(depth) / box(occupancy), after an optional
    inverse-dilation pre-pass (reference ``DepthModule::Upsample_AverageFiltering``
    with ``bDoDilationPreprocessing``). Empty neighbourhoods give 0."""
    if pre_dilate:
        raw_depth = upsample_inverse_dilation(raw_depth, max_dist, pre_kind, pre_size, pre_size)
    occ = (raw_depth > 0).to(raw_depth.dtype)
    s = _window_sum(raw_depth, kernel_size)
    n = _window_sum(occ, kernel_size)
    return torch.where(n > 0, s / n.clamp(min=1.0), 0.0)


_CHAMFER_W = float(np.float32(math.sqrt(2.0)))   # diagonal step, as the f32 JAX weight


def chamfer_distance(occupancy: torch.Tensor, search_radius: int = 7) -> torch.Tensor:
    """Distance from each pixel to the nearest occupied one, capped at
    ``search_radius + 1``: ``search_radius + 1`` rounds of a 3×3 min-plus
    relaxation with weights 1 and √2 (in place of the reference's
    ``cv::distanceTransform(DIST_L2, MASK_5)``)."""
    cap = float(search_radius + 1)
    d = torch.where(occupancy, 0.0, cap).to(torch.float32)
    H, W = d.shape
    for _ in range(search_radius + 1):
        pad = F.pad(d, (1, 1, 1, 1), value=cap)
        best = d
        for dy in range(3):
            for dx in range(3):
                if dy == 1 and dx == 1:
                    continue
                w = _CHAMFER_W if dy != 1 and dx != 1 else 1.0
                best = torch.minimum(best, pad[dy:dy + H, dx:dx + W] + w)
        d = best.clamp(max=cap)
    return d


def nearest_neighbor_depth_at_keypoints(raw_depth: torch.Tensor, kp_uv: torch.Tensor,
                                        search_radius: int = 7) -> torch.Tensor:
    """Per-keypoint nearest-neighbour depth (reference
    ``DepthModule::Upsample_NearestNeighbor_Pixel``): the distance transform
    gives each keypoint a radius r; its depth is the max over the
    (2(r+1))² window anchored as the reference's Rect, [v−r−1, v+r+1) ×
    [u−r−1, u+r+1). A keypoint whose radius reaches ``search_radius`` gets 0.
    The window maxima for every radius are computed once for the whole
    image (one max-pool each), then gathered."""
    H, W = raw_depth.shape
    dist = chamfer_distance(raw_depth > 0, search_radius)
    pooled = torch.stack([
        F.max_pool2d(F.pad(raw_depth[None, None], (r, r - 1, r, r - 1), value=float("-inf")),
                     2 * r, stride=1)[0, 0]
        for r in range(1, search_radius + 1)])                        # (R, H, W)
    u = kp_uv[..., 0].to(torch.int32).clamp(0, W - 1).long()
    v = kp_uv[..., 1].to(torch.int32).clamp(0, H - 1).long()
    r_kp = dist[v, u].to(torch.int32)           # truncation, as the reference
    within = r_kp < search_radius
    d = pooled[r_kp.clamp(0, search_radius - 1).long(), v, u]
    d = torch.where(torch.isfinite(d), d, 0.0)
    return torch.where(within, d.clamp(min=0.0), 0.0)


def _pseudo_stereo(d: torch.Tensor, kp_uv_undist: torch.Tensor, bf: float):
    """(depth, uRight) of keypoints with sampled depth ``d``: d and
    u − bf/d where d > 0, else both −1."""
    valid = d > 0
    depth = torch.where(valid, d, -1.0)
    u_right = torch.where(valid, kp_uv_undist[..., 0] - bf / torch.where(valid, d, 1.0), -1.0)
    return depth, u_right


def feature_depth(depth_map: torch.Tensor, kp_uv: torch.Tensor,
                  kp_uv_undist: torch.Tensor, bf: float):
    """Depth at keypoint pixels and the pseudo-stereo uRight: d =
    map[int(v), int(u)]; if d > 0 then depth = d, uRight = u − bf/d, else
    both −1 (reference ``DepthModule::GetFeatureDepthFromDepthMap``)."""
    H, W = depth_map.shape
    u = kp_uv[..., 0].to(torch.int32).clamp(0, W - 1).long()
    v = kp_uv[..., 1].to(torch.int32).clamp(0, H - 1).long()
    return _pseudo_stereo(depth_map[v, u], kp_uv_undist, bf)


def compute_depth_from_pointcloud(points, P, kp_uv, kp_uv_undist, *, height: int,
                                  width: int, bf: float, method: str = "InverseDilation",
                                  min_dist: float = 5.0, max_dist: float = 200.0,
                                  dil_kind: str = "Diamond", dil_ku: int = 5,
                                  dil_kv: int = 7, valid_mask=None):
    """≡ ``DepthModule::CalculateDepthFromPcd``. Returns (depth_per_kp,
    u_right_per_kp, dense_depth_map); for ``NearestNeighborPixel``, which
    densifies nothing, the third is the raw projection. ``AverageFiltering``
    and ``NearestNeighborPixel`` run at their defaults (box 5 after a
    Diamond-3 pre-dilation; radius 7), as every caller of the JAX package
    runs them."""
    raw = project_pointcloud(points, P, height, width, min_dist, max_dist, valid_mask)
    if method == "None":
        dense = raw
    elif method == "InverseDilation":
        dense = upsample_inverse_dilation(raw, max_dist, dil_kind, dil_ku, dil_kv)
    elif method == "AverageFiltering":
        dense = upsample_average_filtering(raw, max_dist=max_dist)
    elif method == "NearestNeighborPixel":
        depth, u_right = _pseudo_stereo(nearest_neighbor_depth_at_keypoints(raw, kp_uv),
                                        kp_uv_undist, bf)
        return depth, u_right, raw
    else:
        raise ValueError(f"unknown upsampling method: {method}")
    depth, u_right = feature_depth(dense, kp_uv, kp_uv_undist, bf)
    return depth, u_right, dense
