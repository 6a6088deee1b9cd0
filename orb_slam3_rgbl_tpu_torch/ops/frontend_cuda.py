"""Fused dense frontend of a whole image pyramid — FAST-9/16 score + 7-tap
Gaussian blur of every level, and the BRIEF composite of the rounded
blurs — as ONE launch of the hand-written CUDA kernel K1
(``csrc/frontend.cu``).

Counterpart of ``orb_slam3_rgbl_tpu.ops.frontend_pallas.fast_and_blur``
(called once per level there) and of the composite assembly in
``brief_pallas.descriptors_multilevel``. The plain PyTorch version
(``fast_and_blur_levels_plain``) is ``fast.fast_score`` +
``pyramid.gaussian_blur`` per level, then ``brief_cuda.composite``; the
wrappers take it only for tensors on the CPU. For CUDA tensors they launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orb_slam3_rgbl_tpu_torch import cuda_build
from orb_slam3_rgbl_tpu_torch.ops import brief_cuda
from orb_slam3_rgbl_tpu_torch.ops import fast as fast_ops
from orb_slam3_rgbl_tpu_torch.ops import pyramid as pyr_ops

TILE = 32              # csrc/frontend.cu TW = TH: one block per 32×32 output tile
THREADS = 128          # csrc/frontend.cu NWARPS * 32
MAX_LEVELS = 16        # csrc/frontend.cu MAX_LEVELS: most levels of one launch
FILL_W = 256           # csrc/frontend.cu FW: padding columns one fill block zeroes


def fast_and_blur_plain(img: torch.Tensor):
    """(H, W) f32 → (score, blurred): the plain version of K1 on one level."""
    return fast_ops.fast_score(img), pyr_ops.gaussian_blur(img)


def fast_and_blur_levels_plain(levels, *, want_blur: bool = False, want_comp: bool = True):
    """Plain version of ``fast_and_blur_levels``: the per-level plain pair,
    then ``brief_cuda.composite`` of the blurs."""
    pairs = [fast_and_blur_plain(lv) for lv in levels]
    scores = [s for s, _ in pairs]
    blurs = [b for _, b in pairs]
    comp, offs = brief_cuda.composite(blurs) if want_comp else (None, None)
    return scores, (blurs if want_blur else None), comp, offs


def n_tiles(shapes) -> int:
    """Blocks that compute the levels of these (H, W) shapes in one K1 launch."""
    return sum(-(-h // TILE) * -(-w // TILE) for h, w in shapes)


def n_fill_blocks(shapes) -> int:
    """Blocks of that launch that zero the composite's padding: right of
    every level and below the last."""
    Hc, W0, offs = brief_cuda.composite_layout(shapes)
    slack = Hc - (offs[-1] + shapes[-1][0])
    return (sum(-(-h // TILE) * -(-(W0 - w) // FILL_W) for h, w in shapes)
            + -(-slack // TILE) * -(-W0 // FILL_W))


@functools.lru_cache(maxsize=None)
def _taps():
    return (ctypes.c_float * 7)(*[float(v) for v in pyr_ops.gaussian_taps()])


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_build.library("frontend").fast_and_blur_levels_f32
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _check_levels(name: str, levels):
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{name}: takes 1 to {MAX_LEVELS} levels, got {len(levels)}")
    dev = levels[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for img in levels:
        if img.device != dev:
            raise ValueError(f"{name}: levels on {dev} and {img.device}")
        if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
            raise ValueError(f"{name}: expects contiguous (H, W) float32 tensors, "
                             f"got {tuple(img.shape)} {img.dtype}")
        H, W = img.shape
        if H < 4 or W < 4:
            raise ValueError(f"{name}: reflect-101 borders need H, W >= 4, got {H}x{W}")


def _launch_levels(name: str, levels, want_blur: bool, want_comp: bool):
    _check_levels(name, levels)
    dev = levels[0].device
    shapes = [tuple(img.shape) for img in levels]
    scores = [torch.empty_like(img) for img in levels]
    blurs = [torch.empty_like(img) for img in levels] if want_blur else None
    comp = offs = None
    Hc = W0 = 0
    if want_comp:
        # the kernel writes all of it, the zero padding too
        Hc, W0, offs = brief_cuda.composite_layout(shapes)
        comp = torch.empty((Hc, W0), dtype=torch.float32, device=dev)
    n = len(levels)
    ptrs = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    with torch.cuda.device(dev):
        err = _kernel()(n, ptrs(*[t.data_ptr() for t in levels]),
                        ptrs(*[t.data_ptr() for t in scores]),
                        ptrs(*[t.data_ptr() for t in blurs]) if want_blur else None,
                        ints(*[h for h, _ in shapes]), ints(*[w for _, w in shapes]),
                        comp.data_ptr() if want_comp else None,
                        ints(*offs) if want_comp else None, Hc, W0, _taps(),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    cuda_build.launch_counts["fast_and_blur"] += 1
    return scores, blurs, comp, offs


def fast_and_blur_levels(levels, *, want_blur: bool = False, want_comp: bool = True):
    """Pyramid levels (a list of contiguous (H_l, W_l) f32 images) →
    (scores, blurs, comp, offs) in one kernel launch (at most
    ``MAX_LEVELS`` levels).

    scores: per-level FAST scores, bit-identical to ``fast.fast_score``.
    blurs:  per-level unrounded blurs if ``want_blur`` (within 1e-3 of
            ``pyramid.gaussian_blur``; it repeats that arithmetic without
            fused multiply-adds, so on the card it matches to the bit),
            else None.
    comp, offs: if ``want_comp``, the BRIEF composite of the rounded blurs
            and each level's first row in it, exactly
            ``brief_cuda.composite(blurs)``; else None, None."""
    if len(levels) > 0 and levels[0].device.type == "cpu":
        return fast_and_blur_levels_plain(levels, want_blur=want_blur, want_comp=want_comp)
    return _launch_levels("fast_and_blur_levels", levels, want_blur, want_comp)


def fast_and_blur(img: torch.Tensor):
    """(H, W) f32 level image → (score (H, W), blurred (H, W)): the
    one-level case of ``fast_and_blur_levels``, same kernel."""
    if img.device.type == "cpu":
        return fast_and_blur_plain(img)
    scores, blurs, _, _ = _launch_levels("fast_and_blur", [img], True, False)
    return scores[0], blurs[0]
