"""FAST-9/16 corner score + spatially balanced keypoint selection
(counterpart of ``orb_slam3_rgbl_tpu.ops.fast``).

The corner test is evaluated densely, the reference's per-cell threshold
fallback 12→7 is a per-cell mask, and the quadtree is per-cell top-k +
global top-n. Outputs are fixed-size padded tensors with validity masks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# 16-pixel Bresenham circle of radius 3, clockwise from 12 o'clock — (dy, dx).
CIRCLE_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9


def border_mask(H: int, W: int, margin: int, device) -> torch.Tensor:
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin)


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 corner score: max over the 16 circular arcs of
    length 9 of the min contrast in the arc, the better of the two
    polarities, 0 where no corner; zeroed within 3 px of the border.
    Subtractions and min/max only, so every evaluation order gives the
    same bits."""
    H, W = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    c = torch.stack([pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                     for dy, dx in CIRCLE_OFFSETS.tolist()])
    d = c - img[None]

    def arc_reduce(x, op):
        # window of 9 = 8 ⊕ 1: prefix windows of 2, 4, 8 then one extra row
        # (row a of torch.roll(x, -s, 0) is row (a + s) % 16 of x)
        m2 = op(x, torch.roll(x, -1, 0))
        m4 = op(m2, torch.roll(m2, -2, 0))
        m8 = op(m4, torch.roll(m4, -4, 0))
        return op(m8, torch.roll(x, -8, 0))

    bright = arc_reduce(d, torch.minimum).amax(dim=0)
    dark = -arc_reduce(d, torch.maximum).amin(dim=0)
    # "+ 0" turns a -0 into +0, so K1 can be held to the same bits
    score = torch.clamp_min(torch.maximum(bright, dark), 0.0) + 0.0
    return torch.where(border_mask(H, W, 3, img.device), score, 0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3×3 non-maximum suppression (cv::FAST nonmaxSuppression=true)."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= m) & (score > 0), score, 0.0)


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties broken by the lowest index, as
    ``jax.lax.top_k`` does (``torch.topk`` gives no such order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _cell_grid_shape(H: int, W: int, cell: int) -> Tuple[int, int]:
    return (H + cell - 1) // cell, (W + cell - 1) // cell


def select_keypoints(
    score_map: torch.Tensor,
    n_out: int,
    cell: int = 32,
    per_cell_k: int = 8,
    ini_th: float = 12.0,
    min_th: float = 7.0,
    margin: int = 16,
):
    """Spatially balanced keypoint selection: the reference's two-threshold
    policy per cell, the ``per_cell_k`` best per cell, then the global
    best ``n_out``. Returns (uv (n_out, 2) int32, response (n_out,),
    valid (n_out,))."""
    H, W = score_map.shape
    dev = score_map.device
    s = torch.where(border_mask(H, W, margin, dev), nms3(score_map), 0.0)

    ncy, ncx = _cell_grid_shape(H, W, cell)
    Hp, Wp = ncy * cell, ncx * cell
    sp = F.pad(s, (0, Wp - W, 0, Hp - H))
    cells = sp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(ncy * ncx, cell * cell)

    # two-threshold fallback per cell
    has_strong = (cells >= ini_th).any(dim=1, keepdim=True)
    th = torch.where(has_strong, ini_th, min_th)
    cells = torch.where(cells >= th, cells, 0.0)

    k = min(per_cell_k, cell * cell)
    top_v, top_i = _top_k(cells, k)                      # (n_cells, k)
    cidx = torch.arange(ncy * ncx, device=dev)[:, None]
    yy = (cidx // ncx) * cell + top_i // cell
    xx = (cidx % ncx) * cell + top_i % cell

    flat_v = top_v.reshape(-1)
    n_sel = min(n_out, flat_v.shape[0])
    best_v, best_i = _top_k(flat_v, n_sel)
    sel_y = yy.reshape(-1)[best_i]
    sel_x = xx.reshape(-1)[best_i]
    valid = best_v > 0
    if n_sel < n_out:
        padn = n_out - n_sel
        best_v = torch.cat([best_v, best_v.new_zeros(padn)])
        sel_y = torch.cat([sel_y, sel_y.new_zeros(padn)])
        sel_x = torch.cat([sel_x, sel_x.new_zeros(padn)])
        valid = torch.cat([valid, valid.new_zeros(padn)])
    uv = torch.stack([sel_x, sel_y], dim=-1).to(torch.int32)
    return uv, best_v, valid


def features_per_level(n_features: int, n_levels: int, scale_factor: float):
    """Reference's geometric per-level budget (``ORBextractor.cc:448-466``)."""
    inv = 1.0 / scale_factor
    n_first = n_features * (1 - inv) / (1 - inv ** n_levels)
    out = []
    acc = 0
    for l in range(n_levels - 1):
        n = int(round(n_first * inv ** l))
        out.append(n)
        acc += n
    out.append(max(n_features - acc, 0))
    return tuple(out)
