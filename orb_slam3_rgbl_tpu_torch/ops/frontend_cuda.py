"""Fused dense frontend of one pyramid level — FAST-9/16 score + 7-tap
Gaussian blur — as the hand-written CUDA kernel K1 (``csrc/frontend.cu``).

Counterpart of ``orb_slam3_rgbl_tpu.ops.frontend_pallas.fast_and_blur``.
The plain PyTorch version (``fast_and_blur_plain``) is
``fast.fast_score`` + ``pyramid.gaussian_blur``; the wrapper takes it
only for a tensor on the CPU. For a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orb_slam3_rgbl_tpu_torch import cuda_build
from orb_slam3_rgbl_tpu_torch.ops import fast as fast_ops
from orb_slam3_rgbl_tpu_torch.ops import pyramid as pyr_ops


def fast_and_blur_plain(img: torch.Tensor):
    """(H, W) f32 → (score, blurred): the plain version of K1."""
    return fast_ops.fast_score(img), pyr_ops.gaussian_blur(img)


@functools.lru_cache(maxsize=None)
def _taps(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pyr_ops.gaussian_taps()).to(device)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_build.library("frontend").fast_and_blur_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fast_and_blur(img: torch.Tensor):
    """(H, W) f32 level image → (score (H, W), blurred (H, W)).

    Score bit-identical to ``fast.fast_score``; blur within 1e-3 of
    ``pyramid.gaussian_blur`` (it repeats that arithmetic without fused
    multiply-adds, so on the card it matches to the bit as well)."""
    if img.device.type == "cpu":
        return fast_and_blur_plain(img)
    if img.device.type != "cuda":
        raise ValueError(f"fast_and_blur: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("fast_and_blur: expects a contiguous (H, W) float32 tensor, "
                         f"got {tuple(img.shape)} {img.dtype}")
    H, W = img.shape
    if H < 4 or W < 4:
        raise ValueError(f"fast_and_blur: reflect-101 borders need H, W >= 4, got {H}x{W}")
    fn = _kernel()
    score = torch.empty_like(img)
    blur = torch.empty_like(img)
    taps = _taps(img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), score.data_ptr(), blur.data_ptr(), taps.data_ptr(),
                 H, W, stream)
    if err != 0:
        raise RuntimeError(f"fast_and_blur: kernel launch failed (cudaError {err})")
    cuda_build.launch_counts["fast_and_blur"] += 1
    return score, blur
