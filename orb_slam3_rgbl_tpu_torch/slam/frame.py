"""Per-frame feature extraction (counterpart of
``orb_slam3_rgbl_tpu.slam.frame``): pyramid → FAST + blur + BRIEF
composite (kernel K1, one launch over all levels) → balanced selection →
orientation → steered BRIEF over all levels (kernel K2, or K3 in the
binned mode; one launch), then the RGB-L depth association. The output
is a fixed-capacity ``FrameFeatures`` (padded + masked).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.ops import brief_cuda
from orb_slam3_rgbl_tpu_torch.ops import depth as depth_ops
from orb_slam3_rgbl_tpu_torch.ops import fast as fast_ops
from orb_slam3_rgbl_tpu_torch.ops import frontend_cuda
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
