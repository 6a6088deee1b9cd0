"""Image pyramid for multi-scale ORB extraction (counterpart of
``orb_slam3_rgbl_tpu.ops.pyramid``).

8 levels, scale factor 1.2, bilinear downsampling, each level resized
from the previous one (reference ``ORBextractor::ComputePyramid``).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def level_sizes(height: int, width: int, n_levels: int, scale_factor: float) -> Tuple[Tuple[int, int], ...]:
    """(h, w) per level, matching the reference's cvRound(size/scale)."""
    sizes = []
    for l in range(n_levels):
        inv = 1.0 / (scale_factor ** l)
        sizes.append((int(round(height * inv)), int(round(width * inv))))
    return tuple(sizes)


def level_scales(n_levels: int, scale_factor: float):
    """Per-level scale (``mvScaleFactor``)."""
    return tuple(scale_factor ** l for l in range(n_levels))


def gaussian_taps(size: int = 7, sigma: float = 2.0) -> np.ndarray:
    """f32 taps of cv::GaussianBlur(7,7,σ=2) used before descriptor
    sampling (reference ``ORBextractor.cc:1135``)."""
    k = np.exp(-((np.arange(size) - (size - 1) / 2.0) ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, size: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 borders (OpenCV default):
    a vertical then a horizontal pass of shifted multiply-adds, in the
    JAX package's order."""
    k = [float(v) for v in gaussian_taps(size, sigma)]
    pad = size // 2
    H, W = img.shape
    x = F.pad(img[None, None], (0, 0, pad, pad), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(size):
        out = out + k[i] * x[i:i + H, :]
    x = F.pad(out[None, None], (pad, pad, 0, 0), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(size):
        out = out + k[i] * x[:, i:i + W]
    return out


@functools.lru_cache(maxsize=None)
def _linear_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 triangle-kernel weights with half-pixel centers
    and no antialiasing — the arithmetic of ``jax.image.resize(...,
    'linear', antialias=False)`` in f32."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    # XLA fuses (i + 0.5)·inv_scale − 0.5 into one fused multiply-add; the
    # f64 product of two f32 values is exact, so rounding once to f32
    # reproduces it
    centers = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)).astype(np.float64)
    sample_f = (centers * np.float64(inv_scale) - 0.5).astype(np.float32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _linear_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_linear_weights_np(n_in, n_out)).to(device)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel-aligned bilinear resize (cv::resize INTER_LINEAR
    semantics) as two weight-matrix products, like ``jax.image.resize``."""
    H, W = img.shape
    wh = _linear_weights(H, out_hw[0], img.device)     # (H, h)
    ww = _linear_weights(W, out_hw[1], img.device)     # (W, w)
    return (wh.T @ img) @ ww


def build_pyramid(img: torch.Tensor, height: int, width: int,
                  n_levels: int = 8, scale_factor: float = 1.2) -> List[torch.Tensor]:
    """Grayscale f32 image → list of n_levels images, level 0 = input; each
    level is resampled from the previous one, like the reference."""
    sizes = level_sizes(height, width, n_levels, scale_factor)
    out = [img]
    for l in range(1, n_levels):
        out.append(resize_bilinear(out[-1], sizes[l]))
    return out
