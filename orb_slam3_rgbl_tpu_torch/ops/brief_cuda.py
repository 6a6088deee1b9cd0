"""Steered BRIEF over all pyramid levels in one launch, as the
hand-written CUDA kernel K2 (``csrc/brief.cu``).

Counterpart of the continuous path of
``orb_slam3_rgbl_tpu.ops.brief_pallas``: the composite layout of
``descriptors_multilevel``, ``continuous_index_tables`` and
``brief_continuous_pallas``. The binned variant (K3) is not ported yet.

The wrapper ``brief_continuous`` takes its plain version
(``brief_continuous_plain``, a gather through the same index tables) only
for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. Both equal ``orb.brief_descriptors`` on the composite bit for
bit, because the index tables are computed outside the kernel with the
same arithmetic.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orb_slam3_rgbl_tpu_torch import cuda_build
from orb_slam3_rgbl_tpu_torch.ops import orb as orb_ops

# rotated pattern offsets round to at most ±18 (pattern radius ≤ 18.4)
HALF = 18        # pattern center offset inside the patch
PATCH = 40       # patch side (≥ 2·HALF+1)


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
def _kernel():
    fn = cuda_build.library("brief").brief_continuous_i32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def brief_continuous(img_comp: torch.Tensor, corners: torch.Tensor,
                     idx_tables: torch.Tensor) -> torch.Tensor:
    """Continuous-rotation BRIEF for N keypoints → (N, 8) int32 words.

    img_comp: (Hc, Wc) f32 composite of integer-rounded blurred levels.
    corners:  (N, 2) int32 patch corners (u − 18, v − 18), inside
              [0, Wc − 40] × [0, Hc − 40].
    idx_tables: (N, 512) int32 from ``continuous_index_tables``."""
    if img_comp.device.type == "cpu":
        return brief_continuous_plain(img_comp, corners, idx_tables)
    if img_comp.device.type != "cuda":
        raise ValueError(f"brief_continuous: unsupported device {img_comp.device}")
    N = corners.shape[0]
    if (img_comp.dtype != torch.float32 or img_comp.dim() != 2
            or not img_comp.is_contiguous()):
        raise ValueError("brief_continuous: img_comp must be a contiguous (Hc, Wc) float32 tensor")
    Hc, Wc = img_comp.shape
    if Hc < PATCH or Wc < PATCH:
        raise ValueError(f"brief_continuous: composite {Hc}x{Wc} smaller than a patch")
    for name, t, shape in (("corners", corners, (N, 2)), ("idx_tables", idx_tables, (N, 512))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != img_comp.device):
            raise ValueError(f"brief_continuous: {name} must be a contiguous int32 "
                             f"{shape} tensor on {img_comp.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    out = torch.empty((N, 8), dtype=torch.int32, device=img_comp.device)
    if N == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(img_comp.device):
        stream = torch.cuda.current_stream(img_comp.device).cuda_stream
        err = fn(img_comp.data_ptr(), Hc, Wc, corners.data_ptr(), idx_tables.data_ptr(),
                 out.data_ptr(), N, stream)
    if err != 0:
        raise RuntimeError(f"brief_continuous: kernel launch failed (cudaError {err})")
    cuda_build.launch_counts["brief_continuous"] += 1
    return out


def composite(levels_blurred):
    """Blurred levels stacked vertically, intensities rounded to integers
    (the reference compares blurred *uchar* values), padded to the widest
    level — the JAX package's layout, alignment slack included. Returns
    (composite (Hc, W0), row offset per level)."""
    W_img = max(im.shape[1] for im in levels_blurred)
    W0 = ((W_img + 127) // 128) * 128 + 128
    offs = []
    row = 0
    for im in levels_blurred:
        offs.append(row)
        row += im.shape[0]
    Hc = ((row + 7) // 8) * 8 + 16
    comp = levels_blurred[0].new_zeros((Hc, W0))
    for im, off in zip(levels_blurred, offs):
        comp[off:off + im.shape[0], :im.shape[1]] = torch.round(im)
    return comp, offs


def multilevel_inputs(levels_blurred, uv_list, ang_list):
    """K2's inputs for all pyramid levels: the composite, the keypoints in
    composite coordinates (int32) with their angles, the patch corners and
    the index tables. uv_list holds (N_l, 2) level-local coords with a
    margin ≥ 19 from the level border, as ``select_keypoints`` gives them;
    real corners therefore never reach the clamps."""
    comp, offs = composite(levels_blurred)
    Hc, W0 = comp.shape
    uv_all = torch.cat([torch.stack([uv[:, 0], uv[:, 1] + off], dim=1)
                        for uv, off in zip(uv_list, offs)]).to(torch.int32)
    ang_all = torch.cat(list(ang_list))
    corners = torch.stack([(uv_all[:, 0] - HALF).clamp(0, W0 - PATCH),
                           (uv_all[:, 1] - HALF).clamp(0, Hc - PATCH)], dim=1)
    return comp, uv_all, ang_all, corners, continuous_index_tables(ang_all)


def descriptors_multilevel(levels_blurred, uv_list, ang_list):
    """BRIEF descriptors across all pyramid levels in ONE kernel launch.

    levels_blurred: list of (H_l, W_l) f32 blurred level images.
    uv_list: list of (N_l, 2) int32 level-local keypoint coords.
    ang_list: list of (N_l,) f32 angles.
    Returns a list of (N_l, 8) int32 descriptor tensors."""
    comp, _, _, corners, idx = multilevel_inputs(levels_blurred, uv_list, ang_list)
    desc_all = brief_continuous(comp, corners, idx)
    return list(torch.split(desc_all, [uv.shape[0] for uv in uv_list]))
