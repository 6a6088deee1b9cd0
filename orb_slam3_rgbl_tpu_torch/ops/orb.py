"""ORB keypoint orientation (IC_Angle) and steered BRIEF descriptors
(counterpart of ``orb_slam3_rgbl_tpu.ops.orb``).

Descriptors use the published ORB 256-pair sampling pattern
(``orb_pattern.npy``, the port's own copy). Packed descriptors are
(N, 8) **int32** tensors holding the 32-bit words' bit patterns — the JAX
package's uint32 words, reinterpreted (torch's uint32 supports few
operations); ``.numpy().view(np.uint32)`` gives the JAX layout back.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

HALF_PATCH = 15  # reference HALF_PATCH_SIZE = 15 (31×31 patch)

_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy")).astype(np.int32)
# (256, 4) → two point sets (256, 2) as (x, y)
PATTERN_A = _PATTERN[:, 0:2]
PATTERN_B = _PATTERN[:, 2:4]


def _umax_table() -> np.ndarray:
    """Circular-patch row extents for IC_Angle (reference ctor
    ``ORBextractor.cc:468-487``)."""
    umax = np.zeros(HALF_PATCH + 1, dtype=np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


UMAX = _umax_table()


def _circular_mask() -> np.ndarray:
    """(31, 31) bool mask of the orientation patch — rows clipped by UMAX."""
    m = np.zeros((2 * HALF_PATCH + 1, 2 * HALF_PATCH + 1), dtype=bool)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        u_lim = UMAX[abs(v)]
        m[v + HALF_PATCH, HALF_PATCH - u_lim:HALF_PATCH + u_lim + 1] = True
    return m


CIRC_MASK = _circular_mask()


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """Device copies of the sampling pattern and row offsets."""
    pa = torch.from_numpy(PATTERN_A.astype(np.float32)).to(device)
    pb = torch.from_numpy(PATTERN_B.astype(np.float32)).to(device)
    dys = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    dy = torch.from_numpy(dys).to(device)
    umax = torch.from_numpy(UMAX[np.abs(dys)].astype(np.int64)).to(device)
    shifts = torch.arange(32, device=device)
    return pa, pb, dy, umax, shifts


def _prefix_sums(img: torch.Tensor):
    """Row prefix sums of I and x·I with a leading zero column, padded by
    HALF_PATCH on every side (S[y, x+1] = Σ img[y, :x+1])."""
    H, W = img.shape
    hp = HALF_PATCH
    xcoord = torch.arange(W, dtype=img.dtype, device=img.device)[None, :]
    S = F.pad(torch.cumsum(img, dim=1), (1, 0))
    T = F.pad(torch.cumsum(img * xcoord, dim=1), (1, 0))
    return F.pad(S, (hp, hp, hp, hp)), F.pad(T, (hp, hp, hp, hp))


def ic_moment_maps(img: torch.Tensor):
    """Dense intensity-centroid moment maps (m10, m01): each pixel holds
    the circular-patch moments of ``IC_Angle`` (reference
    ``ORBextractor.cc:76-113``), from prefix sums along x of I and x·I."""
    H, W = img.shape
    hp = HALF_PATCH
    Sp, Tp = _prefix_sums(img)
    x0 = torch.arange(W, dtype=img.dtype, device=img.device)[None, :]
    m10 = torch.zeros_like(img)
    m01 = torch.zeros_like(img)
    for dy in range(-hp, hp + 1):
        u = int(UMAX[abs(dy)])
        rows = slice(hp + dy, hp + dy + H)
        row_i = Sp[rows, hp + u + 1:hp + u + 1 + W] - Sp[rows, hp - u:hp - u + W]
        row_xi = (Tp[rows, hp + u + 1:hp + u + 1 + W] - Tp[rows, hp - u:hp - u + W]) - x0 * row_i
        m10 = m10 + row_xi
        m01 = m01 + float(dy) * row_i
    return m10, m01


def ic_angle(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint, radians in [-π, π).

    The moments of ``ic_moment_maps`` evaluated at the keypoints only:
    the same prefix sums and row intervals, gathered for N keypoints
    instead of summed over every pixel (31 row terms per keypoint, summed
    in one reduction — the order of that sum is the only difference)."""
    H, W = img.shape
    hp = HALF_PATCH
    _, _, dy, umax, _ = _consts(img.device)
    Sp, Tp = _prefix_sums(img)
    u = uv[:, 0].long().clamp(0, W - 1)
    v = uv[:, 1].long().clamp(0, H - 1)
    rows = (v[:, None] + hp + dy[None, :])                # (N, 31)
    hi = (u[:, None] + hp + umax[None, :] + 1)
    lo = (u[:, None] + hp - umax[None, :])
    row_i = Sp[rows, hi] - Sp[rows, lo]
    row_xi = (Tp[rows, hi] - Tp[rows, lo]) - u[:, None].to(img.dtype) * row_i
    m10 = row_xi.sum(dim=1)
    m01 = (dy[None, :].to(img.dtype) * row_i).sum(dim=1)
    return torch.atan2(m01, m10)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool → (..., 8) int32 words; bit i of word w is test
    32·w + i (the JAX package's uint32 layout, reinterpreted)."""
    shifts = torch.arange(32, device=bits.device)
    words = (bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def brief_descriptors(img_blurred: torch.Tensor, uv: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 → (N, 8) int32 words (gather form).

    Pattern points rotate by the keypoint angle with rounded
    (nearest-pixel, half-to-even) sampling, the reference's GET_VALUE
    arithmetic: x' = round(px·cosθ − py·sinθ), y' = round(px·sinθ +
    py·cosθ); bit i set iff I(a_i) < I(b_i). Reads clamp to the image."""
    H, W = img_blurred.shape
    pa, pb, _, _, _ = _consts(img_blurred.device)
    ca, sa = torch.cos(angle), torch.sin(angle)

    def rotate(p):  # (256,2) → (N, 256) int offsets
        x = p[None, :, 0] * ca[:, None] - p[None, :, 1] * sa[:, None]
        y = p[None, :, 0] * sa[:, None] + p[None, :, 1] * ca[:, None]
        return torch.round(x).long(), torch.round(y).long()

    ax, ay = rotate(pa)
    bx, by = rotate(pb)
    u0 = uv[:, 0:1].long()
    v0 = uv[:, 1:2].long()
    Ia = img_blurred[(v0 + ay).clamp(0, H - 1), (u0 + ax).clamp(0, W - 1)]
    Ib = img_blurred[(v0 + by).clamp(0, H - 1), (u0 + bx).clamp(0, W - 1)]
    return pack_bits(Ia < Ib)


def unpack_descriptors_pm1(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, 8) int32 words → (N, 256) ±1 rows: hamming(a, b) =
    (256 − a·b) / 2 exactly (integers ≤ 256 are exact in f32 sums)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    bits = bits.reshape(desc.shape[0], 256)
    return (2 * bits - 1).to(dtype)
