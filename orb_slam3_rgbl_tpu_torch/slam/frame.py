"""Per-frame feature extraction (counterpart of
``orb_slam3_rgbl_tpu.slam.frame``): pyramid → FAST + blur + BRIEF
composite (kernel K1, one launch over all levels) → balanced selection →
orientation → steered BRIEF over all levels (kernel K2, or K3 in the
binned mode; one launch), then the depth association: LiDAR (RGB-L) or a
depth image (RGB-D). The output
is a fixed-capacity ``FrameFeatures`` (padded + masked).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import camera as cam_mod
from orb_slam3_rgbl_tpu_torch.ops import brief_cuda
from orb_slam3_rgbl_tpu_torch.ops import depth as depth_ops
from orb_slam3_rgbl_tpu_torch.ops import fast as fast_ops
from orb_slam3_rgbl_tpu_torch.ops import frontend_cuda
from orb_slam3_rgbl_tpu_torch.ops import matching
from orb_slam3_rgbl_tpu_torch.ops import orb as orb_ops
from orb_slam3_rgbl_tpu_torch.ops import pyramid as pyr_ops


class FrameFeatures(NamedTuple):
    """Struct-of-arrays feature frame (fixed capacity N = n_features)."""

    uv: torch.Tensor        # (N, 2) f32 — level-0 pixel coords
    response: torch.Tensor  # (N,)   f32
    octave: torch.Tensor    # (N,)   i32 — pyramid level
    angle: torch.Tensor     # (N,)   f32 — radians
    desc: torch.Tensor      # (N, 8) i32 — packed 256-bit rBRIEF words
    valid: torch.Tensor     # (N,)   bool
    depth: torch.Tensor     # (N,)   f32 — −1 where unknown
    u_right: torch.Tensor   # (N,)   f32 — pseudo-stereo column, −1 invalid

    @property
    def n(self) -> int:
        return self.uv.shape[0]


def extract_features(img, height: int, width: int, n_features: int = 2000,
                     n_levels: int = 8, scale_factor: float = 1.2,
                     ini_th: float = 12.0, min_th: float = 7.0, cell: int = 32,
                     brief_mode: str = "continuous", device=None) -> FrameFeatures:
    """Grayscale f32 (H, W) image → FrameFeatures (depth fields = −1), on
    ``device`` (default ``cuda``).

    ``brief_mode``:
      * 'continuous' (default) — per-keypoint pattern rotation on
        integer-rounded blurred intensities, the reference/OpenCV
        semantics (kernel K2);
      * 'binned' — NB=30-bin quantized rotation, ORB-paper rBRIEF
        (kernel K3);
      * 'legacy' — per-level ``orb.brief_descriptors`` on the unrounded
        blur (plain PyTorch; the JAX package has no kernel for it)."""
    if brief_mode not in ("continuous", "binned", "legacy"):
        raise ValueError(f"extract_features: unknown brief_mode {brief_mode!r}")
    dev = resolve(device)
    img = torch.as_tensor(img, dtype=torch.float32, device=dev)
    levels = [lv.contiguous() for lv in
              pyr_ops.build_pyramid(img, height, width, n_levels, scale_factor)]
    budgets = fast_ops.features_per_level(n_features, n_levels, scale_factor)
    scales = pyr_ops.level_scales(n_levels, scale_factor)

    # legacy reads the unrounded blurs; the other modes the composite of
    # the rounded ones, which K1 writes itself
    legacy = brief_mode == "legacy"
    scores, blurs, comp, offs = frontend_cuda.fast_and_blur_levels(
        levels, want_blur=legacy, want_comp=not legacy)
    uvs, resps, octs, angs, valids, uv_ints, descs = [], [], [], [], [], [], []
    for l, lv in enumerate(levels):
        uv_l, resp_l, valid_l = fast_ops.select_keypoints(
            scores[l], budgets[l], cell=cell, ini_th=ini_th, min_th=min_th, margin=19)
        ang_l = orb_ops.ic_angle(lv, uv_l)
        if legacy:
            descs.append(orb_ops.brief_descriptors(blurs[l], uv_l, ang_l))
        uv_ints.append(uv_l)
        uvs.append(uv_l.to(torch.float32) * scales[l])
        resps.append(resp_l)
        octs.append(torch.full((budgets[l],), l, dtype=torch.int32, device=dev))
        angs.append(ang_l)
        valids.append(valid_l)
    if not legacy:
        descs = brief_cuda.descriptors_multilevel(comp, offs, uv_ints, angs, mode=brief_mode)

    n_total = sum(budgets)
    return FrameFeatures(
        uv=torch.cat(uvs), response=torch.cat(resps), octave=torch.cat(octs),
        angle=torch.cat(angs), desc=torch.cat(descs), valid=torch.cat(valids),
        depth=torch.full((n_total,), -1.0, device=dev),
        u_right=torch.full((n_total,), -1.0, device=dev),
    )


def scale_sigma2(n_levels: int = 8, scale_factor: float = 1.2, device=None) -> torch.Tensor:
    """Per-octave measurement variance (reference ``mvLevelSigma2``), on
    ``device`` (default ``cuda``)."""
    return torch.tensor([scale_factor ** (2 * l) for l in range(n_levels)],
                        dtype=torch.float32, device=resolve(device))


def inv_scale_sigma2(n_levels: int = 8, scale_factor: float = 1.2, device=None) -> torch.Tensor:
    return 1.0 / scale_sigma2(n_levels, scale_factor, device)


def attach_lidar_depth(feats: FrameFeatures, points, P, height: int, width: int,
                       bf: float, min_dist: float = 5.0, max_dist: float = 200.0,
                       method: str = "InverseDilation", dil_kind: str = "Diamond",
                       dil_ku: int = 5, dil_kv: int = 7,
                       valid_mask=None) -> Tuple[FrameFeatures, torch.Tensor]:
    """RGB-L: run the depth engine and bind per-feature depth (reference
    RGBL ``Frame`` ctor). Returns (feats, dense depth map)."""
    d, ur, dense = depth_ops.compute_depth_from_pointcloud(
        points, P, feats.uv, feats.uv, height=height, width=width, bf=bf,
        method=method, min_dist=min_dist, max_dist=max_dist,
        dil_kind=dil_kind, dil_ku=dil_ku, dil_kv=dil_kv, valid_mask=valid_mask)
    d = torch.where(feats.valid, d, -1.0)
    ur = torch.where(feats.valid, ur, -1.0)
    return feats._replace(depth=d, u_right=ur), dense


def attach_depth_map(feats: FrameFeatures, depth_map, bf: float,
                     depth_factor: float = 1.0) -> FrameFeatures:
    """RGB-D: sample a depth image (``depth_map / depth_factor``, metres) at
    the keypoints (reference ``Frame::ComputeStereoFromRGBD``)."""
    d, ur = depth_ops.feature_depth(depth_map / depth_factor, feats.uv, feats.uv, bf)
    d = torch.where(feats.valid, d, -1.0)
    ur = torch.where(feats.valid, ur, -1.0)
    return feats._replace(depth=d, u_right=ur)


def attach_stereo_depth(feats_l: FrameFeatures, feats_r: FrameFeatures, bf: float,
                        min_disp: float = 0.0, max_disp: float = 200.0, n_levels: int = 8,
                        scale_factor: float = 1.2) -> FrameFeatures:
    """Stereo: row-banded Hamming matching of the left features against the
    right image's (``ops.matching.stereo_row_match``) and depth bf /
    disparity where the disparity exceeds 1e-3 px (reference
    ``Frame::ComputeStereoMatches``)."""
    from orb_slam3_rgbl_tpu_torch.ops.matching import stereo_row_match

    dev = feats_l.uv.device
    scale_factors = torch.tensor([scale_factor ** l for l in range(n_levels)],
                                 dtype=torch.float32, device=dev)
    u_right, _ = stereo_row_match(
        feats_l.desc, feats_l.uv[:, 1], feats_l.valid,
        feats_r.desc, feats_r.uv[:, 0], feats_r.uv[:, 1], feats_r.valid, feats_r.octave,
        min_disp, max_disp, feats_l.uv[:, 0], scale_factors)
    disp = feats_l.uv[:, 0] - u_right
    good = (u_right >= 0) & (disp > 1e-3)
    depth = torch.where(good, bf / torch.where(good, disp, 1.0), -1.0)
    return feats_l._replace(depth=depth, u_right=torch.where(good, u_right, -1.0))


def attach_stereo_fisheye_depth(feats_l: FrameFeatures, feats_r: FrameFeatures, cam_l, cam_r,
                                T_lr: torch.Tensor, scale_factor: float = 1.2) -> FrameFeatures:
    """Stereo-fisheye, two unrectified KannalaBrandt8 cameras
    (``Frame::ComputeStereoFishEyeMatches`` + ``KannalaBrandt8::
    TriangulateMatches``): mutual best matches over the full left × right
    Hamming table (ratio 0.8, TH_LOW, rotation check), then both rays
    triangulated with the per-octave σ² (``geometry.camera.
    kb8_triangulate_matches``; T_lr the right camera's pose in the left
    frame). Depth only: fisheye features keep ``u_right`` −1, so every
    residual treats them as mono, and a keyframe mints landmarks from the
    depth. The JAX function's ``bf`` and ``n_levels`` arguments, which it
    does not use, are not carried."""
    d = matching.distance_table(feats_l.desc, feats_r.desc, feats_l.valid, feats_r.valid)
    idx, _ = matching.mutual_best_match(d, feats_l.angle, feats_r.angle, th=matching.TH_LOW,
                                        ratio=0.8, check_rotation=True)
    uv_r = feats_r.uv[idx.clamp(0, feats_r.uv.shape[0] - 1).long()]
    s2 = torch.tensor(scale_factor, dtype=torch.float32, device=feats_l.uv.device) ** (
        2.0 * feats_l.octave.to(torch.float32))
    _, z, ok = cam_mod.kb8_triangulate_matches(cam_l, cam_r, T_lr, feats_l.uv, uv_r, s2, s2)
    good = (idx >= 0) & ok & feats_l.valid
    return feats_l._replace(depth=torch.where(good, z, -1.0))


def _nanmedian_of(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The median of ``values[keep]`` as ``jnp.nanmedian`` gives it — the
    mean of the two middle values of an even count (``torch.nanmedian``
    returns the lower one) — and inf for an empty selection; on the device,
    without a host sync."""
    s = torch.sort(torch.where(keep, values, float("inf"))).values
    n = keep.sum()
    lo = s.gather(0, ((n - 1).clamp_min(0) // 2)[None])[0]
    hi = s.gather(0, (n // 2).clamp_max(s.shape[0] - 1)[None])[0]
    return torch.where(n > 0, lo * 0.5 + hi * 0.5, float("inf"))


def stereo_sad_table(feats: FrameFeatures, gray_l, gray_r, w: int = 5, L: int = 5):
    """The SAD of the (2w+1)² patch around each left keypoint against the
    right image's patches at the 2L+1 columns around its integer match
    (row and columns clamped into the image): (SAD (N, 2L+1), the integer
    centre column (N,))."""
    H, W = gray_l.shape
    dev = feats.uv.device
    P = 2 * w + 1
    vi = torch.round(feats.uv[:, 1]).to(torch.int64).clamp(w, H - w - 1)
    ui = torch.round(feats.uv[:, 0]).to(torch.int64).clamp(w, W - w - 1)
    ur0 = torch.round(feats.u_right).to(torch.int64).clamp(w + L, W - w - L - 1)
    dy = torch.arange(-w, w + 1, device=dev)
    rows = vi[:, None, None] + dy[None, :, None]
    IL = gray_l[rows, ui[:, None, None] + dy[None, None, :]]                     # (N, P, P)
    dxr = torch.arange(-w - L, w + L + 1, device=dev)
    PR = gray_r[rows, ur0[:, None, None] + dxr[None, None, :]]                   # (N, P, P+2L)
    windows = PR.unfold(2, P, 1)                                                 # (N, P, 2L+1, P)
    return (IL[:, :, None, :] - windows).abs().sum(dim=(1, 3)), ur0


def refine_stereo_subpixel(feats: FrameFeatures, gray_l, gray_r, bf: float,
                           w: int = 5, L: int = 5) -> FrameFeatures:
    """SAD subpixel refinement of the stereo matches (reference
    ``Frame::ComputeStereoMatches``, correlation stage): the (2w+1)² patch
    around the left keypoint slides ±L columns around the integer right
    match on the level-0 images; a parabola through the best SAD and its
    neighbours gives the subpixel column; matches whose disparity falls
    under 0.01 px or whose best SAD exceeds 1.5·1.4 × the median are cut.
    A match that is not refined keeps its integer ``u_right`` and depth."""
    has = feats.u_right >= 0
    dists, ur0 = stereo_sad_table(feats, gray_l, gray_r, w, L)
    best = torch.argmin(dists, dim=1)
    interior = (best > 0) & (best < 2 * L)
    bi = best.clamp(1, 2 * L - 1)
    d1 = dists.gather(1, (bi - 1)[:, None])[:, 0]
    d2 = dists.gather(1, bi[:, None])[:, 0]
    d3 = dists.gather(1, (bi + 1)[:, None])[:, 0]
    denom = d1 + d3 - 2.0 * d2
    delta = torch.where(denom.abs() > 1e-6, (d1 - d3) / (2.0 * denom), 0.0)
    ok = has & interior & (delta.abs() <= 1.0)
    best_ur = ur0.to(torch.float32) + (bi - L).to(torch.float32) + delta
    disparity = feats.uv[:, 0] - best_ur
    ok = ok & (disparity > 0.01)
    # median-distance outlier cut (Frame.cc:1059-1072)
    ok = ok & (torch.where(ok, d2, float("inf")) < 1.5 * 1.4 * _nanmedian_of(d2, ok))
    u_right = torch.where(ok, best_ur, feats.u_right)
    depth = torch.where(ok, bf / disparity.clamp_min(1e-3), feats.depth)
    return feats._replace(u_right=u_right, depth=depth)
