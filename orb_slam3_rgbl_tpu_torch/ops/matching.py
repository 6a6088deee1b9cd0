"""Binary descriptor association (counterpart of
``orb_slam3_rgbl_tpu.ops.matching``).

Hamming distance tables come from the ±1 product identity

    hamming(a, b) = (256 − (±1 a) · (±1 b)) / 2

as one f32 matrix product: the sums are integers ≤ 256, exact in f32 in
any order, so the table is exact on the CPU and on the card (torch has
no popcount). Masked/padded keypoints get distance 256. ``argmin``
returns the first minimal index, the JAX package's tie rule.
"""

from __future__ import annotations

import math

import torch

from orb_slam3_rgbl_tpu_torch.ops.orb import unpack_descriptors_pm1

TH_LOW = 50     # reference ORBmatcher.h TH_LOW
TH_HIGH = 100   # reference ORBmatcher.h TH_HIGH
HISTO_LENGTH = 30  # rotation-consistency histogram bins
TWO_PI = 2.0 * math.pi


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element bit count of int32 words (SWAR, in int64 so the shifts
    see the unsigned bit pattern)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 8) × (M, 8) int32 words → (N, M) int32 Hamming distances via
    XOR + popcount (reference path for small tables)."""
    x = a[:, None, :] ^ b[None, :, :]
    return popcount32(x).sum(dim=-1).to(torch.int32)


def hamming_distance_pm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 8) × (M, 8) int32 words → (N, M) f32 Hamming distances via the
    ±1 product identity (exact integers)."""
    av = unpack_descriptors_pm1(a, torch.float32)
    bv = unpack_descriptors_pm1(b, torch.float32)
    return (256.0 - av @ bv.T) * 0.5


def distance_table(desc_a, desc_b, valid_a=None, valid_b=None) -> torch.Tensor:
    """Full masked distance table (N, M) f32; invalid rows/cols → 256."""
    d = hamming_distance_pm1(desc_a, desc_b)
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, 256.0)
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, 256.0)
    return d


def _rotation_consistency(ok: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Keep matches whose rotation falls in the top-3 histogram bins that
    also hold more than 10% of the largest bin (reference
    ``ComputeThreeMaxima``)."""
    rot = torch.remainder(rot, TWO_PI)
    bin_idx = (rot * HISTO_LENGTH / TWO_PI).to(torch.int32).clamp(0, HISTO_LENGTH - 1).long()
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=ok.device)
    hist = hist.scatter_add(0, bin_idx, ok.to(torch.int32))
    top3 = torch.topk(hist, 3).values
    keep_bin = hist >= top3[2].clamp_min(1)
    thresh = (0.1 * hist.max().to(torch.float32)).to(torch.int32)
    keep_bin = keep_bin & (hist > thresh)
    return ok & keep_bin[bin_idx]


def mutual_best_match(dist: torch.Tensor, angles_a=None, angles_b=None,
                      th: float = TH_LOW, ratio: float = 0.9,
                      check_rotation: bool = True):
    """Best match with Lowe ratio + mutual consistency + rotation
    histogram — the common core of every ``ORBmatcher::Search*``.
    Returns (match_idx (N,) int32 into b or −1, match_dist (N,) f32)."""
    best_j = torch.argmin(dist, dim=1)
    rows = torch.arange(dist.shape[0], device=dist.device)
    best_d = dist[rows, best_j]
    d2 = dist.clone()
    d2[rows, best_j] = 256.0
    second_d = d2.amin(dim=1)
    ok = (best_d <= th) & (best_d < ratio * second_d)
    best_i_of_b = torch.argmin(dist, dim=0)
    ok = ok & (best_i_of_b[best_j] == rows)
    if check_rotation and angles_a is not None and angles_b is not None:
        ok = _rotation_consistency(ok, angles_a - angles_b[best_j])
    return torch.where(ok, best_j, -1).to(torch.int32), best_d


def windowed_projection_match(proj_uv, proj_valid, proj_desc, proj_octave,
                              kp_uv, kp_valid, kp_desc, kp_octave, radius,
                              th: float = TH_HIGH, proj_angle=None, kp_angle=None):
    """Project-and-search association (``ORBmatcher::SearchByProjection``):
    for each projected map point, the best keypoint inside its window
    |uv_kp − uv_proj| ≤ radius and octave band [octave−1, octave+1].
    Returns (match_idx (P,) int32 into keypoints or −1, match_dist (P,))."""
    d = distance_table(proj_desc, kp_desc, proj_valid, kp_valid)
    du = kp_uv[None, :, 0] - proj_uv[:, None, 0]
    dv = kp_uv[None, :, 1] - proj_uv[:, None, 1]
    inside = (du.abs() <= radius[:, None]) & (dv.abs() <= radius[:, None])
    band = (kp_octave[None, :] >= proj_octave[:, None] - 1) & (
        kp_octave[None, :] <= proj_octave[:, None] + 1)
    d = torch.where(inside & band, d, 256.0)
    best_j = torch.argmin(d, dim=1)
    best_d = d[torch.arange(d.shape[0], device=d.device), best_j]
    ok = best_d <= th
    if proj_angle is not None and kp_angle is not None:
        ok = _rotation_consistency(ok, proj_angle - kp_angle[best_j])
    return torch.where(ok, best_j, -1).to(torch.int32), best_d


def stereo_row_match(desc_l, v_l, valid_l, desc_r, u_r, v_r, valid_r, octave_r,
                     min_disp: float, max_disp: float, u_l, scale_factors,
                     th: float = TH_HIGH):
    """Row-banded stereo matching (``Frame::ComputeStereoMatches``):
    right keypoints within ±2·scale rows of the left keypoint (the scale of
    the right keypoint's octave) and with disparity u_l − u_r in
    [min_disp, max_disp] are candidates; the first minimal Hamming distance
    wins if it is ≤ ``th``. The (N, M) table is the masked
    ``distance_table``; nothing larger is built.

    The JAX function also takes the left octaves, which it does not use.

    Returns (u_right (N,) f32 or −1, best distance (N,) f32)."""
    d = distance_table(desc_l, desc_r, valid_l, valid_r)
    row_tol = 2.0 * scale_factors[octave_r.clamp(0, scale_factors.shape[0] - 1).long()]
    row_ok = (v_l[:, None] - v_r[None, :]).abs() <= row_tol[None, :]
    disp = u_l[:, None] - u_r[None, :]
    d = torch.where(row_ok & (disp >= min_disp) & (disp <= max_disp), d, 256.0)
    best_j = torch.argmin(d, dim=1)
    best_d = d.gather(1, best_j[:, None])[:, 0]
    u_right = torch.where(best_d <= th, u_r[best_j], -1.0)
    return u_right, best_d
