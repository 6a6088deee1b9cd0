"""Steered BRIEF over all pyramid levels in one launch, as the
hand-written CUDA kernels K2 and K3 (``csrc/brief.cu``).

Counterpart of ``orb_slam3_rgbl_tpu.ops.brief_pallas``: the composite
layout of ``descriptors_multilevel`` and its two modes.

* continuous (the default): per-keypoint rotation, kernel K2
  ``brief_continuous``: angles in, descriptor words out. The kernel
  rotates the pattern itself with the arithmetic of
  ``continuous_index_tables`` op for op, on ``torch.cos``/``torch.sin`` of
  the angles, so it equals its plain version (tables, then gather) and
  ``orb.brief_descriptors`` on the composite bit for bit; the (N, 512)
  tables exist only in the plain version.
* binned: rotation quantized to ``NB`` angle bins, keypoints laid out by
  ``bin_pure_layout`` into blocks of ``BLK`` slots that share one
  pattern table (``binned_pattern_tables``), kernel K3 ``brief_blocks``.
  Equal to ``brief_binned_plain`` (the gather form) for every keypoint
  whose patch lies inside the composite.

Each wrapper takes its plain version (``brief_continuous_plain``,
``brief_blocks_plain``) only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises. The layout is built from sort, scatter and
``searchsorted`` only, so a binned extraction does not wait for the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch import cuda_build
from orb_slam3_rgbl_tpu_torch.ops import orb as orb_ops

NB = 30          # angle bins (2π/30 = 12°, ORB-paper rBRIEF quantization)
BLK = 64         # slots per bin-pure block
# rotated pattern offsets round to at most ±18 (pattern radius ≤ 18.4)
HALF = 18        # pattern center offset inside the patch
PATCH = 40       # patch side (≥ 2·HALF+1)
K2_KPB = 2       # keypoints per 256-thread block of K2 (csrc/brief.cu)
K3_KPB = 8       # slots per 256-thread block of K3 (csrc/brief.cu)


@functools.lru_cache(maxsize=None)
def _pattern(device: torch.device) -> torch.Tensor:
    pa, pb, _, _, _ = orb_ops._consts(device)
    return torch.cat([pa, pb], dim=0)                      # (512, 2) x, y


def continuous_index_tables(angle: torch.Tensor) -> torch.Tensor:
    """(N,) angles → (N, 512) int32 patch positions (A points then B
    points) with per-keypoint rotation — the f32 round(cos/sin) arithmetic
    of ``orb.brief_descriptors``, op for op."""
    P = _pattern(angle.device)
    ca, sa = torch.cos(angle), torch.sin(angle)
    x = torch.round(P[None, :, 0] * ca[:, None] - P[None, :, 1] * sa[:, None])
    y = torch.round(P[None, :, 0] * sa[:, None] + P[None, :, 1] * ca[:, None])
    return ((y + HALF) * PATCH + (x + HALF)).to(torch.int32)


def brief_continuous_plain(img_comp: torch.Tensor, corners: torch.Tensor,
                           idx_tables: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the 512 samples of each keypoint's patch,
    gathered through its index table. Clamps corners and table entries
    as the kernel does."""
    Hc, Wc = img_comp.shape
    u = corners[:, 0:1].long().clamp(0, Wc - PATCH)
    v = corners[:, 1:2].long().clamp(0, Hc - PATCH)
    idx = idx_tables.long().clamp(0, PATCH * PATCH - 1)
    vals = img_comp[v + idx // PATCH, u + idx % PATCH]       # (N, 512)
    return orb_ops.pack_bits(vals[:, :256] < vals[:, 256:])


@functools.lru_cache(maxsize=None)
def _pattern4(device: torch.device) -> torch.Tensor:
    """(256, 4) f32 (ax, ay, bx, by): one float4 per test, K2's layout."""
    pa, pb, _, _, _ = orb_ops._consts(device)
    return torch.cat([pa, pb], dim=1).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_build.library("brief").brief_continuous_i32
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _rotation_kernel():
    fn = cuda_build.library("brief").brief_rotation_tables_i32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(fn_name: str, name: str, t: torch.Tensor, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{fn_name}: {name} must be a contiguous {dtype} {shape} tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def brief_continuous(img_comp: torch.Tensor, corners: torch.Tensor,
                     angle: torch.Tensor) -> torch.Tensor:
    """Continuous-rotation BRIEF for N keypoints → (N, 8) int32 words.

    img_comp: (Hc, Wc) f32 composite of integer-rounded blurred levels.
    corners:  (N, 2) int32 patch corners (u − 18, v − 18), inside
              [0, Wc − 40] × [0, Hc − 40].
    angle:    (N,) f32 keypoint angles in radians."""
    if img_comp.device.type == "cpu":
        return brief_continuous_plain(img_comp, corners, continuous_index_tables(angle))
    if img_comp.device.type != "cuda":
        raise ValueError(f"brief_continuous: unsupported device {img_comp.device}")
    N = corners.shape[0]
    if (img_comp.dtype != torch.float32 or img_comp.dim() != 2
            or not img_comp.is_contiguous()):
        raise ValueError("brief_continuous: img_comp must be a contiguous (Hc, Wc) float32 tensor")
    Hc, Wc = img_comp.shape
    if Hc < PATCH or Wc < PATCH:
        raise ValueError(f"brief_continuous: composite {Hc}x{Wc} smaller than a patch")
    _check("brief_continuous", "corners", corners, torch.int32, (N, 2), img_comp.device)
    _check("brief_continuous", "angle", angle, torch.float32, (N,), img_comp.device)
    out = torch.empty((N, 8), dtype=torch.int32, device=img_comp.device)
    if N == 0:
        return out
    # cos and sin by the plain version's own calls: the kernel's rounded
    # positions then rest on the same f32 values (see csrc/brief.cu)
    ca, sa = torch.cos(angle), torch.sin(angle)
    fn = _kernel()
    with torch.cuda.device(img_comp.device):
        stream = torch.cuda.current_stream(img_comp.device).cuda_stream
        err = fn(img_comp.data_ptr(), Hc, Wc, corners.data_ptr(), ca.data_ptr(), sa.data_ptr(),
                 _pattern4(img_comp.device).data_ptr(), out.data_ptr(), N, stream)
    if err != 0:
        raise RuntimeError(f"brief_continuous: kernel launch failed (cudaError {err})")
    cuda_build.launch_counts["brief_continuous"] += 1
    return out


def rotation_tables(angle: torch.Tensor) -> torch.Tensor:
    """(N,) angles on the card → the (N, 512) int32 patch positions as K2's
    rotation computes them, for checks against ``continuous_index_tables``
    (which this equals entry for entry)."""
    if angle.device.type != "cuda":
        raise ValueError(f"rotation_tables: runs only on a CUDA tensor, got {angle.device}")
    N = angle.shape[0]
    _check("rotation_tables", "angle", angle, torch.float32, (N,), angle.device)
    out = torch.empty((N, 512), dtype=torch.int32, device=angle.device)
    if N == 0:
        return out
    ca, sa = torch.cos(angle), torch.sin(angle)
    fn = _rotation_kernel()
    with torch.cuda.device(angle.device):
        stream = torch.cuda.current_stream(angle.device).cuda_stream
        err = fn(ca.data_ptr(), sa.data_ptr(), _pattern4(angle.device).data_ptr(),
                 out.data_ptr(), N, stream)
    if err != 0:
        raise RuntimeError(f"rotation_tables: kernel launch failed (cudaError {err})")
    return out


# ---------------------------------------------------------------------------
# Binned rBRIEF (K3)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def binned_pattern_tables() -> np.ndarray:
    """(NB, 512) int32 — linearized PATCH×PATCH-patch position of each
    rotated pattern point (A points then B points) per angle bin, rotated
    by the bin center with f32 round(cos/sin) arithmetic."""
    pa = orb_ops.PATTERN_A.astype(np.float32)
    pb = orb_ops.PATTERN_B.astype(np.float32)
    out = np.zeros((NB, 512), np.int32)
    for b in range(NB):
        a = np.float32((b + 0.5) * 2.0 * np.pi / NB - np.pi)
        ca, sa = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
        for off, p in ((0, pa), (256, pb)):
            x = np.round(p[:, 0] * ca - p[:, 1] * sa).astype(np.int32)
            y = np.round(p[:, 0] * sa + p[:, 1] * ca).astype(np.int32)
            assert np.abs(x).max() <= HALF and np.abs(y).max() <= HALF
            out[b, off:off + 256] = (y + HALF) * PATCH + (x + HALF)
    return out


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(binned_pattern_tables()).to(device)


def angle_bins(angle: torch.Tensor) -> torch.Tensor:
    """Radians in [-π, π) → int32 bin id in [0, NB): floor((a + π)·NB/2π)
    in f32, the JAX package's arithmetic."""
    b = torch.floor((angle + math.pi) * (NB / (2.0 * math.pi))).to(torch.int32)
    return b.clamp(0, NB - 1)


def brief_binned_plain(img: torch.Tensor, uv: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Binned rBRIEF in gather form (counterpart of ``brief_binned_ref``):
    each of the 512 samples of a keypoint's bin table, read at its own
    clamped coordinate. ``img`` holds integer-rounded intensities."""
    H, W = img.shape
    idx = _tables(img.device)[angle_bins(angle).long()].long()   # (N, 512)
    yy = (uv[:, 1:2].long() + idx // PATCH - HALF).clamp(0, H - 1)
    xx = (uv[:, 0:1].long() + idx % PATCH - HALF).clamp(0, W - 1)
    vals = img[yy, xx]
    return orb_ops.pack_bits(vals[:, :256] < vals[:, 256:])


def slot_capacity(n_total: int) -> int:
    """Static slot count: every bin may waste up to BLK−1 slots."""
    cap = n_total + NB * (BLK - 1)
    return ((cap + BLK - 1) // BLK) * BLK


def bin_pure_layout(bins: torch.Tensor, S: int):
    """Assign each keypoint a slot such that every BLK-slot block holds
    keypoints of a single bin (the JAX package's layout: bins in order,
    each padded to whole blocks, keypoints of a bin in their input order).

    Returns (slots (N,) int32, block_bins (S // BLK, 1) int32). Built from
    a stable sort, scatters and ``searchsorted`` (right side), none of
    which waits for the card (``bincount`` would)."""
    dev = bins.device
    N = bins.shape[0]
    b = bins.long()
    counts = torch.zeros(NB, dtype=torch.int64, device=dev).scatter_add_(
        0, b, torch.ones(N, dtype=torch.int64, device=dev))
    padded = (counts + BLK - 1) // BLK * BLK
    ends = torch.cumsum(padded, 0)
    base = ends - padded
    start = torch.cumsum(counts, 0) - counts
    order = torch.sort(b, stable=True).indices
    sorted_bins = b[order]
    slot_sorted = base[sorted_bins] + torch.arange(N, device=dev) - start[sorted_bins]
    slots = torch.empty(N, dtype=torch.int64, device=dev).scatter_(0, order, slot_sorted)
    block_starts = torch.arange(S // BLK, dtype=torch.int64, device=dev) * BLK
    block_bins = torch.searchsorted(ends, block_starts, right=True).clamp(0, NB - 1)
    return slots.to(torch.int32), block_bins.to(torch.int32).reshape(-1, 1)


def _slot_bins(block_bins: torch.Tensor, S: int) -> torch.Tensor:
    slot = torch.arange(S, device=block_bins.device)
    return block_bins.reshape(-1).long().clamp(0, NB - 1)[slot // BLK]


def brief_blocks_plain(img_comp: torch.Tensor, corners: torch.Tensor,
                       block_bins: torch.Tensor) -> torch.Tensor:
    """Plain version of K3, on K3's exact inputs: slot s reads the patch
    at ``corners[s]`` through the table of bin ``block_bins[s // BLK]``.
    Clamps corners, bins and table entries as the kernel does."""
    idx = _tables(img_comp.device)[_slot_bins(block_bins, corners.shape[0])]
    return brief_continuous_plain(img_comp, corners, idx)


@functools.lru_cache(maxsize=None)
def _blocks_kernel():
    fn = cuda_build.library("brief").brief_binned_i32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def brief_blocks(img_comp: torch.Tensor, corners: torch.Tensor,
                 block_bins: torch.Tensor) -> torch.Tensor:
    """Binned rBRIEF over S bin-pure slots → (S, 8) int32 words.

    img_comp: (Hc, Wc) f32 composite of integer-rounded blurred levels.
    corners:  (S, 2) int32 patch corners (u − 18, v − 18), slot-ordered.
    block_bins: (⌈S / BLK⌉, 1) int32 angle bin of each block.
    Padding slots (corner (1, 1) from ``descriptors_multilevel``) get
    words that nothing reads."""
    if img_comp.device.type == "cpu":
        return brief_blocks_plain(img_comp, corners, block_bins)
    if img_comp.device.type != "cuda":
        raise ValueError(f"brief_blocks: unsupported device {img_comp.device}")
    S = corners.shape[0]
    if (img_comp.dtype != torch.float32 or img_comp.dim() != 2
            or not img_comp.is_contiguous()):
        raise ValueError("brief_blocks: img_comp must be a contiguous (Hc, Wc) float32 tensor")
    Hc, Wc = img_comp.shape
    if Hc < PATCH or Wc < PATCH:
        raise ValueError(f"brief_blocks: composite {Hc}x{Wc} smaller than a patch")
    n_blocks = (S + BLK - 1) // BLK
    _check("brief_blocks", "corners", corners, torch.int32, (S, 2), img_comp.device)
    _check("brief_blocks", "block_bins", block_bins, torch.int32, (n_blocks, 1), img_comp.device)
    out = torch.empty((S, 8), dtype=torch.int32, device=img_comp.device)
    if S == 0:
        return out
    tables = _tables(img_comp.device)
    fn = _blocks_kernel()
    with torch.cuda.device(img_comp.device):
        stream = torch.cuda.current_stream(img_comp.device).cuda_stream
        err = fn(img_comp.data_ptr(), Hc, Wc, corners.data_ptr(), block_bins.data_ptr(),
                 tables.data_ptr(), out.data_ptr(), S, stream)
    if err != 0:
        raise RuntimeError(f"brief_blocks: kernel launch failed (cudaError {err})")
    cuda_build.launch_counts["brief_blocks"] += 1
    return out


# ---------------------------------------------------------------------------
# Composite layout over all pyramid levels
# ---------------------------------------------------------------------------

def composite_layout(shapes):
    """(Hc, W0, row offset per level) of the composite of levels with these
    (H, W) shapes: levels stacked vertically, padded to the widest level —
    the JAX package's layout, alignment slack included."""
    W_img = max(w for _, w in shapes)
    W0 = ((W_img + 127) // 128) * 128 + 128
    offs = []
    row = 0
    for h, _ in shapes:
        offs.append(row)
        row += h
    Hc = ((row + 7) // 8) * 8 + 16
    return Hc, W0, offs


def composite(levels_blurred):
    """Blurred levels in ``composite_layout``, intensities rounded to
    integers (the reference compares blurred *uchar* values), zero
    elsewhere. Returns (composite (Hc, W0), row offset per level). The
    plain version of what kernel K1 writes itself."""
    Hc, W0, offs = composite_layout([tuple(im.shape) for im in levels_blurred])
    comp = levels_blurred[0].new_zeros((Hc, W0))
    for im, off in zip(levels_blurred, offs):
        comp[off:off + im.shape[0], :im.shape[1]] = torch.round(im)
    return comp, offs


def multilevel_inputs(comp, offs, uv_list, ang_list):
    """The kernels' common inputs for all pyramid levels, given the
    composite and its row offsets (``composite`` or
    ``frontend_cuda.fast_and_blur_levels``): the keypoints in composite
    coordinates (int32) with their angles, and the patch corners. uv_list
    holds (N_l, 2) level-local coords with a margin ≥ 19 from the level
    border, as ``select_keypoints`` gives them; real corners therefore
    never reach the clamps."""
    Hc, W0 = comp.shape
    uv_all = torch.cat([torch.stack([uv[:, 0], uv[:, 1] + off], dim=1)
                        for uv, off in zip(uv_list, offs)]).to(torch.int32)
    ang_all = torch.cat(list(ang_list))
    corners = torch.stack([(uv_all[:, 0] - HALF).clamp(0, W0 - PATCH),
                           (uv_all[:, 1] - HALF).clamp(0, Hc - PATCH)], dim=1)
    return uv_all, ang_all, corners


def binned_inputs(corners: torch.Tensor, ang_all: torch.Tensor):
    """K3's slot layout for N keypoints: S = ``slot_capacity(N)`` slot
    corners (padding slots at (1, 1), as the JAX package fills them), the
    block bins, and each keypoint's slot."""
    S = slot_capacity(corners.shape[0])
    slots, block_bins = bin_pure_layout(angle_bins(ang_all), S)
    slot_corners = torch.ones((S, 2), dtype=torch.int32, device=corners.device)
    slot_corners.index_copy_(0, slots.long(), corners)
    return slot_corners, block_bins, slots


def descriptors_multilevel(comp, offs, uv_list, ang_list, mode: str = "continuous"):
    """BRIEF descriptors across all pyramid levels in ONE kernel launch.

    comp, offs: the composite of the rounded blurred levels and each
      level's first row in it (``composite``, or K1's own output).
    uv_list: list of (N_l, 2) int32 level-local keypoint coords.
    ang_list: list of (N_l,) f32 angles.
    mode: 'continuous' (K2, per-keypoint rotation) or 'binned' (K3,
      NB-bin quantized rotation).
    Returns a list of (N_l, 8) int32 descriptor tensors."""
    _, ang_all, corners = multilevel_inputs(comp, offs, uv_list, ang_list)
    if mode == "continuous":
        desc_all = brief_continuous(comp, corners, ang_all)
    elif mode == "binned":
        slot_corners, block_bins, slots = binned_inputs(corners, ang_all)
        desc_all = brief_blocks(comp, slot_corners, block_bins)[slots.long()]
    else:
        raise ValueError(f"descriptors_multilevel: unknown mode {mode!r}")
    return list(torch.split(desc_all, [uv.shape[0] for uv in uv_list]))
