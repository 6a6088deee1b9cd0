#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phase 0 builds the CUDA kernels from ``orb_slam3_rgbl_tpu_torch/csrc``.
Phase 1 runs each kernel at the main path's shapes on a rendered
1241×376 frame — K1 ``fast_and_blur`` on all 8 pyramid levels in one
launch (and on each level alone), K2 ``brief_continuous`` on the frame's
2000 keypoints, K3 ``brief_blocks`` on their 3904 bin-pure slots —
compares it with its plain version (bit for bit) and times both, beside
an empty kernel at each kernel's grid (the floor of a launch on this
card).
Phase 2 drives the main path, ``System.track_rgbl``, first in its
tracking-only configuration (``enable_mapping=False``, ``loop_closing=False``;
phase 5 turns the mapping plane on and phase 6 runs the default
configuration, loop closing included), at the
KITTI configuration (1241×376, 2000 features, 8 levels, 131,072-point
clouds staged on the card, an 8192-landmark window) over 1 + 40 frames of
a synthetic street canyon with a keyframe forced every 4 frames: frame 1
on the classic ladder, every later frame on the fused step. It checks
states, keyframes, launch counts, the window's growth, the absence of
host syncs inside the step and the trajectory against ground truth, and
prints host ms per kind of frame.
Phase 3 feeds 12 textureless frames and 3 textured ones: OK →
RECENTLY_LOST → LOST, a second atlas map, and tracking again.
Phase 4 runs the binned-BRIEF extraction (K3) on 5 of the drive's frames
beside the continuous one.
Phase 5 drives the same 41 frames through ``System(cfg,
enable_mapping=True)`` with the natural keyframe policy (and, if that
makes fewer than 6 keyframes, again with one forced every 4 frames): after
every keyframe the synchronous mapping job — landmark culling,
triangulation, fusion, Schur local BA, keyframe culling — runs on the
card. It checks every frame's state, the map's binding invariants after
every job, that landmarks were triangulated, that no local BA raised its
cost, that the solve does not wait for the card, and the trajectory; it
prints the jobs' host ms, one job split by ``map.*`` span, the plane's
counts, the window's size beside the tracking-only drive's and the
tracking host ms with mapping on. For the natural policy it prints, frame
by frame, what the keyframe decision saw and which clause fired, here and
on a 320×192 drive of 600 features (the size of the CPU tests).
Phase 6 drives ``System(cfg)`` with nothing switched off — mapping and loop
closing on — over 132 frames of a circle of 6 m radius inside a closed
square room (one lap of 84 frames, then 48 frames over the start): every
keyframe is indexed in the keyframe database, a loop is detected, verified
by Sim3, corrected (fusion, essential graph, landmark re-anchoring) and
followed by a 16-iteration global BA. It checks the event's keyframes, every
frame's state, that the frames after the event stay on the fused step, the
binding invariants after the correction and after the global BA's
writeback, both solvers' costs, that a second global BA of the same snapshot
gives the same bits, that none of the three loop solvers waits for the card,
the launch counts and the trajectory after the loop; it prints what every
keyframe, candidate and event cost, the event split by ``loop.*`` span.
Then 6 textureless frames and 6 frames of a place the lap mapped: the
tracker must come back through relocalization against the database, in the
same atlas map.
Phase 7 drives ``System(cfg)`` with nothing switched off over the canyon of
phase 2 (its 41 frames with a keyframe forced every 4), 12 textureless
frames with the camera held at its last pose (a lost streak past ``fps``:
a second atlas map starts) and the 15 frames that follow on the path: the
new map's first keyframe is recognized in the archived map's database,
verified by Sim3 and welded (``slam/merging.py``). It checks that the atlas
is back to one map, every frame after the weld, the frames that leave the
fused step, the binding invariants before and after the weld-window BA,
that BA's cost, the scale, the trajectory against ground truth (ATE) and
that ``optimize_sim3`` and the BA do not wait for the card; it prints the
weld's counts and host ms by ``merge.*`` span, then drives the same frames
again with the revisit under the profiler.
Phase 8 trains a tree vocabulary (k=8, depth=3) on phase 6's map, holds its
recall@3 against the LSH words' on that frozen map, times one ``bow`` of a
frame, and drives phase 6's forced pass again with ``vocab_path`` set: it
must close the loop.

``--mapping-drive N`` runs, instead of the phases, N frames tracking only
and then with the mapping plane on (a keyframe every 4 in both): the
window's and the map's growth over a longer drive.

The last line is ``{"ok": true, "device": {...}}`` (no arguments); any
failure exits non-zero before it. Without a CUDA device the script exits 1 at once.
It uses one card: unless ``CUDA_VISIBLE_DEVICES`` is set, it sees only
the first. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam3_rgbl_tpu_torch import cuda_build
from orb_slam3_rgbl_tpu_torch import synthetic as syn
from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
from orb_slam3_rgbl_tpu_torch.geometry import align, lie
from orb_slam3_rgbl_tpu_torch.ops import brief_cuda, depth as depth_ops, fast as fast_ops
from orb_slam3_rgbl_tpu_torch.ops import frontend_cuda
from orb_slam3_rgbl_tpu_torch.ops import orb as orb_ops, pyramid as pyr_ops
from orb_slam3_rgbl_tpu_torch.optim import local_ba, pose_graph
from orb_slam3_rgbl_tpu_torch.optim import sim3 as sim3_opt
from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
from orb_slam3_rgbl_tpu_torch.retrieval.tree_vocab import train_vocabulary
from orb_slam3_rgbl_tpu_torch.slam import frame as frame_mod, tracking as trk
from orb_slam3_rgbl_tpu_torch.slam import map_state as map_mod, merging
from orb_slam3_rgbl_tpu_torch.slam.compiled import lidar_projection
from orb_slam3_rgbl_tpu_torch.slam.local_mapping import MAP_SPANS, LocalMapper
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath
from orb_slam3_rgbl_tpu_torch.slam.loop_closing import LOOP_SPANS, LoopCloser
from orb_slam3_rgbl_tpu_torch.slam.system import System
from orb_slam3_rgbl_tpu_torch.slam.tracking import Tracker

SEED = 0
T_START = time.perf_counter()
N_DRIVE = 41            # the initialization frame + 40 tracked frames
N_PROFILED = 3          # the drive's last frames run under torch.profiler
KF_EVERY = 4            # forced keyframe cadence (the JAX engine bench's)
MIN_KEYFRAMES = 10
N_BLANK, N_AFTER = 12, 3    # phase 3: textureless frames, then textured ones
N_BINNED = 5            # phase 4: binned extractions
MIN_MAPPING_KEYFRAMES = 6   # phase 5: fewer under the natural policy → a forced pass too
N_LATE = 14             # phase 5: frames of the closing tracking-only drive
PROFILED_JOB = 4        # phase 5: the mapping job (0-based) run under torch.profiler
CLOUD_AZ, CLOUD_EL = 2048, 64   # 131,072 points (System.CLOUD_CAP)
# phase 6: frames of the loop drive, frames a lap, the circle's radius (m)
N_LOOP, LOOP_PERIOD, LOOP_RADIUS = 132, 84, 6.0
MIN_LOOP_FRAME_GAP = 30     # frames between the loop's two keyframes
MAX_CLASSIC_AFTER_LOOP = 3  # frames right after the event that may leave the fused step
PROFILED_ITERATIONS = 2     # iterations of the pose graph and of the global BA under the profiler
# phase 6, relocalization: textureless frames (fewer than fps: no new map),
# then this many frames from frame RELOC_BACK_TO of the lap on
N_RELOC_BLANK, RELOC_BACK_TO, N_RELOC_AFTER = 6, 40, 6
MIN_INLIERS = 30
# phase 7: frames right after the weld that may leave the fused step
MAX_CLASSIC_AFTER_WELD = 3
# phase 8: the tree vocabulary's shape (tests/test_tree_vocab_e2e.py's), the
# first frame of the lap's revisit stretch, and the recall bounds of that test
VOCAB_K, VOCAB_DEPTH, REVISIT_FROM = 8, 3, 88
MIN_TREE_RECALL, MAX_RECALL_GAP = 0.5, 0.34
VOCAB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "vocab",
                          "phase8.npz")
# translation error bound against ground truth over the drive (metres):
# ~3x the 0.118 m this 41-frame loop reaches when its helpers run on the
# CPU at this size. At 320x192 the same loop ends at 0.181 m on both the
# port and the JAX System (0.8 mm apart), and tests/test_torch_system.py
# holds the two within 5 mm frame by frame
MAX_TRANS_ERR_M = 0.35
MAX_EXTRACT_KERNELS = 810   # track.extract in a profiled fused frame (837 with 8 K1 launches)
BLUR_TOL = 1e-3         # K1 blur vs pyramid.gaussian_blur (tests/test_brief_pallas.py bar)

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): 3.35 TB/s of HBM and
# 67 TFLOP/s of f32 outside the tensor cores. The 67 counts a fused
# multiply-add as two operations; the kernels' operations (sub, min, max,
# mul, add, compare, each its own instruction) retire at most one per lane
# per clock, half that rate. min/max may issue slower still; the bound
# does not assume so, and stays a floor.
HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2
# K1 operations per pixel, in the leanest form known to give the same bits
# (the one csrc/frontend.cu uses): the pixel turned into its integer order
# key (2); 2 × 32 three-input min/max for the 16 circular 9-long arc windows
# (windows of 3, then of 9) and 2 × 8 to reduce over the arcs; the two
# winning keys turned back into floats (2 × 2); 2 subtractions of the
# centre; 3 for the score (max, max with 0, + 0); 28 for the two 7-tap blur
# passes (7 multiplies and 7 adds each, unfused); 1 rounding for the
# composite. A three-input integer min/max is priced like any other single
# instruction, one per lane per clock.
K1_OPS_PER_PIXEL = 2 + 64 + 16 + 4 + 2 + 3 + 28 + 1
# K2 operations per test: two rotated points (4 multiplies, 2 sums, 2
# roundings and 4 for the patch index each), one compare, one bit pack
K2_OPS_PER_TEST = 2 * 12 + 2


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call from CUDA events over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _on_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def _ms(evt) -> float:
    return (evt.time_range.end - evt.time_range.start) / 1e3


def _profile():
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=act)


def kernel_device_ms(fn, name: str, iters: int = 20) -> float:
    """Mean device time of the kernels named ``name`` per call of ``fn``,
    from torch.profiler (kernel time alone, without launch gaps). An empty
    name sums every kernel the call launches."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a trace now and then comes back without device events
        with _profile() as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(_ms(e) for e in prof.events() if name in e.name and _on_device(e))
        if total > 0.0:
            return total / iters
    fail(f"torch.profiler recorded no device time for {name or 'any kernel'!r} in three traces")


def empty_launch_ms(blocks: int, threads: int):
    """(device ms, event ms) of an empty kernel at this grid: the floor of
    one launch on this card, through the same ctypes path as K1 and K2."""
    fn = cuda_build.library("launch_floor").empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        err = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"empty kernel launch failed (cudaError {err})")

    return kernel_device_ms(launch, "empty_kernel"), time_cuda(launch)


def sass_counts(lib_path: str, kernel: str):
    """Opcode histogram of ``kernel``'s machine code in a built library,
    from ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        return None
    counts, inside = collections.Counter(), False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1)] += 1
    return counts


def bound(n_bytes: float, n_ops: float):
    """(least ms, what bounds it) for moving n_bytes and issuing n_ops
    single f32 instructions."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sampled_pixels(comp, corners, idx) -> int:
    """Distinct composite pixels that some test samples (with the plain
    version's clamps)."""
    Hc, Wc = comp.shape
    u = corners[:, 0:1].long().clamp(0, Wc - brief_cuda.PATCH)
    v = corners[:, 1:2].long().clamp(0, Hc - brief_cuda.PATCH)
    i = idx.long().clamp(0, brief_cuda.PATCH ** 2 - 1)
    return torch.unique((v + i // brief_cuda.PATCH) * Wc + u + i % brief_cuda.PATCH).numel()


def brief_bytes(comp, corners, idx) -> dict:
    """Least bytes K2 (angles in, words out) must move on these inputs,
    term by term: each composite pixel its tests sample, once (``idx``
    only says which); the corners; cos and sin of every angle; the 256 x 4
    f32 pattern; the output words."""
    N = corners.shape[0]
    return {"sampled pixels": 4.0 * sampled_pixels(comp, corners, idx),
            "corners": 8.0 * N, "cos and sin": 8.0 * N, "pattern": 4096.0, "output": 32.0 * N}


def brief_blocks_bytes(comp, corners, block_bins) -> float:
    """Least bytes K3 must move on these inputs: each sampled composite
    pixel once (all slots, padding included), the 30 x 512 pattern tables,
    the corners, the block bins and the output words."""
    S = corners.shape[0]
    idx = brief_cuda._tables(comp.device)[brief_cuda._slot_bins(block_bins, S)]
    return (4.0 * sampled_pixels(comp, corners, idx) + brief_cuda.binned_pattern_tables().nbytes
            + corners.numel() * 4.0 + block_bins.numel() * 4.0 + 32.0 * S)


def kitti_synthetic_config():
    """``kitti_rgbl_config()`` with its LiDAR extrinsics replaced by the
    synthetic world's axis swap, in the tracking-only configuration
    (loop closing off)."""
    cfg = kitti_rgbl_config()
    lidar = dataclasses.replace(cfg.lidar, T_velo_cam=tuple(syn.T_VELO_CAM.reshape(-1).tolist()))
    return dataclasses.replace(cfg, lidar=lidar, loop_closing=False)


def render_drive(cfg, n_frames: int, device, n_az: int = CLOUD_AZ, n_el: int = CLOUD_EL,
                 seed: int = SEED):
    """Ground truth, images and clouds (with all-true masks) of the canyon
    drive — set-up work, made on ``device``."""
    cam = cfg.camera
    world = syn.make_world(seed, device=device)
    traj = syn.straight_trajectory(n_frames, step=0.6, weave=0.4)
    frames = []
    for Twc in traj:
        img = syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy,
                               cam.height, cam.width).contiguous()
        pts = syn.lidar_scan(world, Twc, n_az=n_az, n_el=n_el)
        frames.append((img, pts, torch.ones(pts.shape[0], dtype=torch.bool, device=device)))
    return traj, frames


def drive(cfg, frames, device, sysm=None, t0: int = 0, on_frame=None,
          kf_every: int = KF_EVERY):
    """Feed ``frames`` to ``System.track_rgbl`` (a new tracking-only
    System unless ``sysm`` is given; its first tracker forces a keyframe
    every ``kf_every`` frames, 0 for the natural policy). Returns the
    System and per-frame (TrackResult, host ms). ``on_frame(i)`` may
    return a context manager wrapped around frame i."""
    if sysm is None:
        sysm = System(cfg, enable_mapping=False, device=device)
        sysm.CLOUD_CAP = frames[0][1].shape[0]
    results = []
    for i, (img, pts, mask) in enumerate(frames):
        with on_frame(i) if on_frame is not None else contextlib.nullcontext():
            t0_host = time.perf_counter()
            res = sysm.track_rgbl(img, pts, (t0 + i) * 0.1, cloud_mask=mask)
            if device.type == "cuda":
                # the tracking thread's stream: worker streams run on
                torch.cuda.current_stream(device).synchronize()
            ms = (time.perf_counter() - t0_host) * 1e3
        if t0 + i == 0:
            sysm.tracker.force_kf_every = kf_every
        results.append((res, ms))
    return sysm, results


@contextlib.contextmanager
def spy(calls: list, sync_ms: list):
    """Record which tracking stages each frame runs (``calls``) and the
    host ms of every ``FastPath.sync`` that refreshed the device state
    (``sync_ms``, synchronized), by wrapping the methods for the duration."""
    names = ("_track_reference_keyframe", "_track_with_motion_model", "_track_local_map",
             "_accept_fused")
    originals = {n: getattr(Tracker, n) for n in names}
    orig_sync = FastPath.sync

    def wrap(name, fn):
        def wrapper(self, *a, **k):
            calls.append(name)
            return fn(self, *a, **k)
        return wrapper

    def timed_sync(self, *a, **k):
        key = self._sync_key
        t = time.perf_counter()
        orig_sync(self, *a, **k)
        if self._sync_key is not key:
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            sync_ms.append((time.perf_counter() - t) * 1e3)

    for n, fn in originals.items():
        setattr(Tracker, n, wrap(n, fn))
    FastPath.sync = timed_sync
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(Tracker, n, fn)
        FastPath.sync = orig_sync


@contextlib.contextmanager
def count_calls(module, name: str):
    """Count the calls of ``module.name`` for the duration (yields a
    one-element list holding the count)."""
    original = getattr(module, name)
    n = [0]

    def counted(*a, **k):
        n[0] += 1
        return original(*a, **k)

    setattr(module, name, counted)
    try:
        yield n
    finally:
        setattr(module, name, original)


def trans_errors(traj, results) -> np.ndarray:
    est = np.stack([lie.np_se3_centers(r.pose) for r, _ in results])
    return np.linalg.norm(est - (traj[: len(est), 4:7] - traj[0, 4:7]), axis=1)


def bits_equal(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase1_kernels(cfg, device) -> dict:
    """K1, K2 and K3 against their plain versions at the main path's shapes."""
    cam, o = cfg.camera, cfg.orb
    _, frames = render_drive(cfg, 1, device, n_az=64, n_el=8)
    levels = [lv.contiguous() for lv in pyr_ops.build_pyramid(
        frames[0][0], cam.height, cam.width, o.n_levels, o.scale_factor)]
    budgets = fast_ops.features_per_level(o.n_features, o.n_levels, o.scale_factor)
    n_px = sum(lv.numel() for lv in levels)
    shapes = [tuple(lv.shape) for lv in levels]
    k1_blocks = frontend_cuda.n_tiles(shapes) + frontend_cuda.n_fill_blocks(shapes)

    # K1, all levels in one launch, every output asked for
    scores, blurs, comp, offs = frontend_cuda.fast_and_blur_levels(levels, want_blur=True)
    scores_p, blurs_p, comp_p, offs_p = frontend_cuda.fast_and_blur_levels_plain(
        levels, want_blur=True)
    torch.cuda.synchronize()
    k1_err, blur_same = 0.0, True
    for l, lv in enumerate(levels):
        H, W = lv.shape
        if not bits_equal(scores[l], scores_p[l]):
            fail(f"K1 level {l} ({H}x{W}): score differs from fast_score at "
                 f"{int((scores[l] != scores_p[l]).sum())} pixels")
        err = float((blurs[l] - blurs_p[l]).abs().max())
        if not err <= BLUR_TOL:
            fail(f"K1 level {l}: blur max |diff| {err} > {BLUR_TOL}")
        k1_err = max(k1_err, err)
        blur_same = blur_same and bits_equal(blurs[l], blurs_p[l])
        # the same level alone, through the one-level entry
        score1, blur1 = frontend_cuda.fast_and_blur(lv)
        if not (bits_equal(score1, scores_p[l]) and bits_equal(blur1, blurs[l])):
            fail(f"K1 level {l}: the one-level launch differs from the all-level launch")
    if offs != offs_p or not bits_equal(comp, comp_p):
        fail(f"K1: composite differs from composite(plain blurs) at "
             f"{int((comp != comp_p).sum())} pixels")
    # the main path's form: scores and composite, no unrounded blurs
    scores_m, none_m, comp_m, _ = frontend_cuda.fast_and_blur_levels(levels)
    if none_m is not None or not bits_equal(comp_m, comp_p) or not all(
            bits_equal(a, b) for a, b in zip(scores_m, scores_p)):
        fail("K1: the composite-only launch differs from the plain version")
    log(f"K1 {len(levels)} levels ({n_px} pixels, {k1_blocks} blocks, "
        f"{frontend_cuda.n_fill_blocks(shapes)} of them for the composite's padding) in one "
        f"launch: scores bit-identical, composite {tuple(comp.shape)} bit-identical "
        f"to composite(plain blurs), unrounded blur max|diff| {k1_err:.3g} "
        f"({'bit-identical' if blur_same else 'not bit-identical'}); each level alone: the same")

    def k1_all():
        return frontend_cuda.fast_and_blur_levels(levels)

    def k1_each():
        return [frontend_cuda.fast_and_blur(lv) for lv in levels]

    ms1 = time_cuda(k1_all)
    ms1_each = time_cuda(k1_each)
    dms1 = kernel_device_ms(k1_all, "fast_blur_kernel")
    dms1_each = kernel_device_ms(k1_each, "fast_blur_kernel")
    dms1_call = kernel_device_ms(k1_all, "")
    pms1 = time_cuda(lambda: frontend_cuda.fast_and_blur_levels_plain(levels), iters=20)
    log(f"K1 one launch over {len(levels)} levels (scores + composite, padding included): "
        f"{ms1:.4f} ms by events, kernel alone {dms1:.4f} ms on the device ({dms1_call:.4f} ms "
        f"for every kernel of the call); "
        f"{len(levels)} one-level launches (scores + blurs): {ms1_each:.4f} ms by events, "
        f"{dms1_each:.4f} ms on the device; plain {pms1:.4f} ms a frame")

    uvs, angs = [], []
    for l, lv in enumerate(levels):
        uv, _, _ = fast_ops.select_keypoints(scores[l], budgets[l], ini_th=float(o.ini_th_fast),
                                             min_th=float(o.min_th_fast), margin=19)
        uvs.append(uv)
        angs.append(orb_ops.ic_angle(lv, uv))

    uv_all, ang, corners = brief_cuda.multilevel_inputs(comp, offs, uvs, angs)
    idx = brief_cuda.continuous_index_tables(ang)
    Hc, Wc = comp.shape
    N = corners.shape[0]

    def k2_plain():
        return brief_cuda.brief_continuous_plain(comp, corners,
                                                 brief_cuda.continuous_index_tables(ang))

    d_k = brief_cuda.brief_continuous(comp, corners, ang)
    d_p = k2_plain()
    d_g = orb_ops.brief_descriptors(comp, uv_all, ang)
    torch.cuda.synchronize()
    if not torch.equal(d_k, d_p):
        fail(f"K2: {int((d_k != d_p).any(1).sum())} of {N} descriptors differ from the "
             f"plain version")
    # keypoints whose patch lies inside the composite (all real ones) must
    # also equal the gather form, which clamps each sample instead
    inside = (uv_all[:, 0] >= brief_cuda.HALF) & (uv_all[:, 1] >= brief_cuda.HALF)
    if not torch.equal(d_k[inside], d_g[inside]):
        fail("K2 differs from orb.brief_descriptors on the composite")
    k2_err = bit_mismatch(d_k, d_p)
    # the rotation itself, all N x 512 positions, against the tables of the
    # plain version
    rot = brief_cuda.rotation_tables(ang)
    if not torch.equal(rot, idx):
        fail(f"K2's rotation differs from continuous_index_tables at "
             f"{int((rot != idx).sum())} of {idx.numel()} positions")

    def k2():
        return brief_cuda.brief_continuous(comp, corners, ang)

    ms2 = time_cuda(k2)
    pms2 = time_cuda(k2_plain)
    gms2 = time_cuda(lambda: orb_ops.brief_descriptors(comp, uv_all, ang))
    dms2 = kernel_device_ms(k2, "brief_kernel")
    dms2_call = kernel_device_ms(k2, "")
    log(f"K2 {N} keypoints on a {Hc}x{Wc} composite: bit-identical to the plain version "
        f"(tables, then gather) and to orb.brief_descriptors ({int(inside.sum())} in-patch "
        f"keypoints), all {idx.numel()} rotated positions equal to continuous_index_tables; "
        f"{ms2:.4f} ms by events, kernel alone {dms2:.4f} ms on the device ({dms2_call:.4f} ms "
        f"with cos and sin); plain {pms2:.4f} ms, gather form {gms2:.4f} ms")

    # the floor of a launch: an empty kernel at K1's and at K2's grid
    grids = {"K1": (k1_blocks, frontend_cuda.THREADS),
             "K2": (-(-N // brief_cuda.K2_KPB), 256)}
    for name, (blocks, threads) in grids.items():
        floor_dev, floor_evt = empty_launch_ms(blocks, threads)
        log(f"empty kernel at {name}'s grid ({blocks} x {threads}): {floor_dev:.4f} ms on "
            f"the device, {floor_evt:.4f} ms by events")

    # K3 on the same keypoints, laid out in bin-pure blocks
    slot_corners, block_bins, slots = brief_cuda.binned_inputs(corners, ang)
    S = slot_corners.shape[0]
    d3_k = brief_cuda.brief_blocks(comp, slot_corners, block_bins)
    d3_p = brief_cuda.brief_blocks_plain(comp, slot_corners, block_bins)
    d3_g = brief_cuda.brief_binned_plain(comp, uv_all, ang)
    torch.cuda.synchronize()
    if S != brief_cuda.slot_capacity(N):
        fail(f"K3: {S} slots for {N} keypoints, expected {brief_cuda.slot_capacity(N)}")
    if not torch.equal(d3_k, d3_p):
        fail(f"K3: {int((d3_k != d3_p).any(1).sum())} of {S} slots differ from brief_blocks_plain")
    if not torch.equal(d3_k[slots.long()][inside], d3_g[inside]):
        fail("K3 differs from brief_binned_plain on the real keypoints")
    k3_err = bit_mismatch(d3_k, d3_p)

    def k3():
        return brief_cuda.brief_blocks(comp, slot_corners, block_bins)

    ms3 = time_cuda(k3)
    pms3 = time_cuda(lambda: brief_cuda.brief_blocks_plain(comp, slot_corners, block_bins))
    gms3 = time_cuda(lambda: brief_cuda.brief_binned_plain(comp, uv_all, ang))
    dms3 = kernel_device_ms(k3, "brief_binned_kernel")
    log(f"K3 {S} slots ({N} keypoints, {block_bins.shape[0]} blocks) on the same composite: "
        f"bit-identical to brief_blocks_plain on all {S} slots and to brief_binned_plain on "
        f"{int(inside.sum())} keypoints; kernel {ms3:.4f} ms (device time alone {dms3:.4f} ms), "
        f"plain {pms3:.4f} ms, gather form {gms3:.4f} ms")
    floor_dev, floor_evt = empty_launch_ms(-(-S // brief_cuda.K3_KPB), 256)
    log(f"empty kernel at K3's grid ({-(-S // brief_cuda.K3_KPB)} x 256): {floor_dev:.4f} ms on "
        f"the device, {floor_evt:.4f} ms by events")

    k2_terms = brief_bytes(comp, corners, idx)
    log("K2 least bytes: " + ", ".join(f"{k} {v:.0f}" for k, v in k2_terms.items()))
    k2_bytes = sum(k2_terms.values())
    k2_ops = 256.0 * K2_OPS_PER_TEST * N
    k3_bytes = brief_blocks_bytes(comp, slot_corners, block_bins)
    k3_ops = 512.0 * S
    # K1: every level read and its score written (4 B a pixel each), the
    # whole composite written, padding included; the 7 taps travel in the
    # launch's parameters
    k1_terms = {"levels read": 4.0 * n_px, "scores": 4.0 * n_px, "composite": 4.0 * comp.numel()}
    log("K1 least bytes: " + ", ".join(f"{k} {v:.0f}" for k, v in k1_terms.items()))
    bounds = {"K1": (sum(k1_terms.values()), float(K1_OPS_PER_PIXEL * n_px)),
              "K2": (k2_bytes, k2_ops),
              "K3": (k3_bytes, k3_ops)}
    for name, (nb, no) in bounds.items():
        t, by = bound(nb, no)
        log(f"bound {name}: {nb:.0f} B, {no:.0f} ops -> {t * 1e3:.3f} us ({by})")
    return {
        "fast_and_blur": dict(ms=ms1, device_ms=dms1, plain_ms=pms1, err=k1_err,
                              bound=bound(*bounds["K1"])),
        "brief_continuous": dict(ms=ms2, device_ms=dms2, plain_ms=pms2, err=k2_err,
                                 bound=bound(*bounds["K2"])),
        "brief_blocks": dict(ms=ms3, device_ms=dms3, plain_ms=pms3, err=k3_err,
                             bound=bound(*bounds["K3"])),
    }


def bit_mismatch(a, b) -> float:
    """Largest |difference| of the descriptors' bits (0 or 1)."""
    bits = orb_ops.unpack_descriptors_pm1(a) != orb_ops.unpack_descriptors_pm1(b)
    return float(bits.to(torch.float32).max()) if bits.numel() else 0.0


def profile_frames(prefix: str = "track."):
    """(context manager factory, stats): torch.profiler over one frame (or
    one mapping job, with ``prefix`` "map."). Appends per use (device busy
    ms, kernel count, {kernel name: [ms, calls]}, {span: (host ms, device
    busy ms, kernels)}). Busy time sums kernel durations; a kernel belongs
    to the span (``compiled.STEP_SPANS``, ``local_mapping.MAP_SPANS``)
    whose device-side range holds its start."""
    stats = []

    @contextlib.contextmanager
    def ctx():
        with _profile() as prof:
            yield
            torch.cuda.synchronize()
        events = list(prof.events())
        spans = [e for e in events if e.name.startswith(prefix)]
        host_ms = {e.name: _ms(e) for e in spans if not _on_device(e)}
        dev_spans = [e for e in spans if _on_device(e)]
        by_name = collections.defaultdict(lambda: [0.0, 0])
        by_span = collections.defaultdict(lambda: [0.0, 0])
        for e in events:
            if not _on_device(e) or e.name.startswith(prefix):
                continue
            by_name[e.name][0] += _ms(e)
            by_name[e.name][1] += 1
            for s in dev_spans:
                if s.time_range.start <= e.time_range.start <= s.time_range.end:
                    by_span[s.name][0] += _ms(e)
                    by_span[s.name][1] += 1
                    break
        stats.append((sum(v[0] for v in by_name.values()), sum(v[1] for v in by_name.values()),
                      dict(by_name), {k: (v, *by_span.get(k, (0.0, 0))) for k, v in host_ms.items()}))

    return ctx, stats


def check_no_sync(tracker, frame, device):
    """Run the fused step once more (result unused) with PyTorch's sync
    debug mode raising on any synchronizing call inside it."""
    img, pts, mask = frame
    pred = torch.as_tensor(tracker._predict_pose_fused(), device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tracker.fast.run(img, pts, mask, pred)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("sync check: a fused step ran under torch.cuda.set_sync_debug_mode('error') "
        "without a synchronizing call")


def ba_robust_cost(problem, poses, landmarks, cam):
    """Huber cost of a BA state over every masked observation (a device
    scalar): the same function before and after a solve."""
    P = problem._replace(poses=poses, landmarks=landmarks)
    return local_ba._linearize(P, cam, True, problem.obs_mask)[6]


@contextlib.contextmanager
def spy_mapping(jobs: list, ba_runs: list, prof_ctx):
    """For the duration, time every ``LocalMapper.process_keyframe``
    (``jobs``: kf id, host ms synchronized, binding faults after it), run
    job number ``PROFILED_JOB`` under the profiler, and record every local
    BA's problem and Huber cost before and after (``ba_runs``)."""
    orig_job = LocalMapper.process_keyframe
    orig_ba = local_ba.bundle_adjust

    def timed_job(self, kf_id, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with prof_ctx() if len(jobs) == PROFILED_JOB else contextlib.nullcontext():
            orig_job(self, kf_id, *a, **k)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        jobs.append((kf_id, ms, map_mod.check_binding_consistency(self.map)))

    def recorded_ba(problem, cam, **k):
        before = ba_robust_cost(problem, problem.poses, problem.landmarks, cam)
        res = orig_ba(problem, cam, **k)
        ba_runs.append((problem, cam, k, before,
                        ba_robust_cost(problem, res.poses, res.landmarks, cam), res.cost))
        return res

    LocalMapper.process_keyframe = timed_job
    local_ba.bundle_adjust = recorded_ba
    try:
        yield
    finally:
        LocalMapper.process_keyframe = orig_job
        local_ba.bundle_adjust = orig_ba


@contextlib.contextmanager
def spy_kf_policy(rows: list):
    """Record, for every keyframe decision of a fused frame, what
    ``Tracker._fast_kf_policy`` saw and which clause of NeedNewKeyFrame
    asked for a keyframe (``rows``: frame id, inliers, the reference
    keyframe's tracked landmarks, the ratio threshold, close points
    tracked and not tracked, the clause)."""
    original = Tracker._fast_kf_policy

    def traced(self, n_inl, tracked_close, nontracked_close):
        made = original(self, n_inl, tracked_close, nontracked_close)
        ref = self._ref_kf_tracked() if self.ref_kf >= 0 else 0
        th_ref = 0.4 if self.map.n_kf < 2 else 0.75
        if not made:
            clause = "-"
        elif (self.force_kf_every > 0
              and self.frame_id >= self.last_kf_frame + self.force_kf_every):
            clause = "forced"
        elif self._need_close(tracked_close, nontracked_close):
            clause = "close"
        else:
            clause = "ratio"
        rows.append((self.frame_id, n_inl, ref, th_ref, tracked_close, nontracked_close, clause))
        return made

    Tracker._fast_kf_policy = traced
    try:
        yield
    finally:
        Tracker._fast_kf_policy = original


def log_kf_policy(what: str, rows: list):
    """One line per drive: frame:inliers/threshold×tracked(close tracked,
    not tracked)clause — the clause is ``ratio`` (inliers under the
    threshold's share of the reference keyframe's tracked landmarks),
    ``close`` (under 100 close points tracked and over 70 not), ``forced``
    or ``-`` (no keyframe)."""
    log(f"keyframe policy, {what} (frame:inliers/share*tracked(close tracked,untracked)clause): "
        + " ".join(f"{f}:{n}/{th}*{ref}({tc},{ntc}){cl}" for f, n, ref, th, tc, ntc, cl in rows))
    fired = collections.Counter(cl for *_, cl in rows if cl != "-")
    log(f"keyframe policy, {what}: clauses that made a keyframe: {dict(fired)}")


def small_policy_drive(device, n_frames: int):
    """The natural keyframe policy at the size the CPU tests hold against
    the JAX package (320x192, 600 features, 4 levels, 12,288-point clouds),
    mapping on, over the same trajectory: which clause makes its keyframes,
    beside the KITTI-size drive's."""
    cfg = dataclasses.replace(syn.synthetic_rgbl_config(), loop_closing=False)
    _, frames = render_drive(cfg, n_frames, device, n_az=256, n_el=48)
    sysm = System(cfg, enable_mapping=True, device=device)
    sysm.CLOUD_CAP = frames[0][1].shape[0]
    rows = []
    with spy_kf_policy(rows):
        sysm, results = drive(cfg, frames, device, sysm=sysm, kf_every=0)
    sysm.shutdown()
    if any(r.state != trk.OK for r, _ in results):
        fail("a frame of the 320x192 policy drive is not OK")
    log(f"320x192 policy drive: {n_frames} frames, {sysm.map.n_kf} keyframes created at frames "
        + " ".join(str(i) for i, (r, _) in enumerate(results) if r.created_kf))
    log_kf_policy("320x192, 600 features", rows)


def phase5_mapping(cfg, frames, traj, device, kf_every: int, tracking_only: dict,
                   max_err: float = MAX_TRANS_ERR_M) -> int:
    """The drive with the local-mapping plane on. Returns the number of
    keyframes it created."""
    policy = "the natural keyframe policy" if kf_every == 0 else f"a keyframe forced every {kf_every}"
    prof_ctx, prof_stats = profile_frames("map.")
    jobs, ba_runs, windows, policy_rows = [], [], [], []

    @contextlib.contextmanager
    def on_frame(i):
        yield
        windows.append(len(sysm._fast.win_ids) if sysm._fast else 0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    sysm = System(cfg, enable_mapping=True, device=device)
    sysm.CLOUD_CAP = frames[0][1].shape[0]
    with spy_mapping(jobs, ba_runs, prof_ctx), spy_kf_policy(policy_rows):
        sysm, results = drive(cfg, frames, device, sysm=sysm, on_frame=on_frame,
                              kf_every=kf_every)
    sysm.shutdown()
    counts = dict(cuda_build.launch_counts)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    m, n = sysm.map, len(frames)

    states = [r.state for r, _ in results]
    kf = [r.created_kf for r, _ in results]
    errs = trans_errors(traj, results)
    log(f"mapping drive ({policy}): keyframe frames " + " ".join(str(i) for i, k in enumerate(kf) if k))
    log("mapping drive inliers: " + " ".join(str(r.n_inliers) for r, _ in results[1:]))
    if kf_every == 0:
        log_kf_policy(f"{cfg.camera.width}x{cfg.camera.height}, {cfg.orb.n_features} features",
                      policy_rows)
    log("mapping drive trans err m: " + " ".join(f"{e:.3f}" for e in errs))
    if any(st != trk.OK for st in states):
        fail(f"mapping drive states {[trk.STATE_NAMES[st] for st in states]}: every frame must be OK")
    if sysm.async_mapping:
        fail("the mapping plane must run synchronously")
    if counts["fast_and_blur"] != n or counts["brief_continuous"] != n:
        fail(f"mapping drive launch counts {counts} over {n} frames; expected 1 K1 and 1 K2 per frame")
    for kf_id, _, faults in jobs:
        if faults:
            fail(f"check_binding_consistency after keyframe {kf_id}: {faults}")
    live = m.valid_kf_ids()
    if not (np.isfinite(m.kf_pose[live]).all() and np.isfinite(m.lm_pos[m.lm_valid]).all()
            and all(np.isfinite(r.pose).all() for r, _ in results)):
        fail("a pose or a landmark of the mapping drive is not finite")
    c = sysm.mapper.counts
    if len(jobs) != sum(kf) - 1:
        fail(f"{len(jobs)} mapping jobs for {sum(kf)} keyframes; expected one after each but the first")
    log(f"mapping jobs host ms (keyframe: ms): " + " ".join(f"{k}: {ms:.1f}" for k, ms, _ in jobs))
    timed_jobs = [ms for i, (_, ms, _) in enumerate(jobs) if i != PROFILED_JOB]
    if timed_jobs:
        log(f"mapping job host ms: median {statistics.median(timed_jobs):.1f} max "
            f"{max(timed_jobs):.1f} over {len(timed_jobs)} jobs (job {PROFILED_JOB} ran under "
            f"the profiler and is left out)")
    if prof_stats and prof_stats[0][1] > 0:
        busy, n_kernels, by_name, by_span = prof_stats[0]
        log(f"profiled mapping job (keyframe {jobs[PROFILED_JOB][0]}): device busy {busy:.2f} ms "
            f"in {n_kernels} kernels")
        for span in MAP_SPANS:
            if span in by_span:
                host, sbusy, sn = by_span[span]
                log(f"  span {span:18s} host {host:8.2f} ms  device busy {sbusy:7.3f} ms  kernels {sn}")
        for name, (ms, n_calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            log(f"  {ms:8.3f} ms {n_calls:6d} calls  {name[:110]}")
    elif len(jobs) > PROFILED_JOB:
        log("profiler: no device events recorded for the mapping job (not measured)")
    if ba_runs:
        costs = torch.stack([torch.stack([b, a, r]) for _, _, _, b, a, r in ba_runs]).cpu().numpy()
        log("local BA Huber cost over all observations, before -> after (solver's final cost): "
            + "; ".join(f"{b:.1f} -> {a:.1f} ({r:.1f})" for b, a, r in costs))
        if not np.isfinite(costs).all() or (costs[:, 1] > costs[:, 0]).any():
            fail("a local BA raised its cost or returned a non-finite one")
        problem, cam, kwargs = ba_runs[-1][:3]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            local_ba.bundle_adjust(problem, cam, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        M, D = problem.obs_kf.shape
        log(f"sync check: bundle_adjust ({problem.poses.shape[0]} poses, {M} landmark slots, "
            f"{D} observations each, {kwargs}) ran under set_sync_debug_mode('error') without a "
            f"synchronizing call")
    log(f"mapping plane over the drive: {c['triangulated']} landmarks triangulated, "
        f"{c['fuse_bound']} observations bound and {c['fuse_replaced']} landmarks replaced by "
        f"fusion, {c['mp_culled']} landmarks culled, {c['kf_culled']} keyframes culled, "
        f"{c['lba_runs']} local BAs, {c['lba_outlier_obs']} outlier observations unbound, "
        f"{c['lba_dropped_obs']} observations dropped by the {sysm.mapper.obs_cap}-per-landmark cap")
    if c["triangulated"] == 0:
        fail("no landmark was triangulated over the mapping drive")
    if sum(kf) >= 3 and c["lba_runs"] == 0:
        fail("no local BA ran over the mapping drive")
    log("window size per frame, mapping on:  " + " ".join(str(w) for w in windows))
    log("window size per frame, tracking only: " + " ".join(str(w) for w in tracking_only["windows"]))
    if not float(errs.max()) < max_err:
        fail(f"mapping drive translation error {errs.max():.3f} m >= {max_err} m")
    job_ms = dict(zip([i for i, k in enumerate(kf) if k][1:], [ms for _, ms, _ in jobs]))
    kinds = {"no keyframe": [ms for i, (_, ms) in enumerate(results) if i > 1 and not kf[i]],
             "keyframe, tracking part": [ms - job_ms.get(i, 0.0) for i, (_, ms) in enumerate(results)
                                         if i > 1 and kf[i]]}
    for kind, ms in kinds.items():
        if ms:
            log(f"mapping drive host ms/frame, {kind}: {len(ms)} frames, median "
                f"{statistics.median(ms):.2f}, all {' '.join(f'{x:.1f}' for x in ms)}")
    log(f"mapping drive ({policy}): {n} frames, {sum(kf)} keyframes created, {live.size} alive, "
        f"{int(m.lm_valid.sum())} landmarks alive (tracking only: "
        f"{tracking_only['landmarks']}); max trans err {errs.max():.3f} m (tracking only "
        f"{tracking_only['max_err']:.3f} m, bound {max_err:.2f}); launches {counts}; peak "
        f"memory {peak_mb:.0f} MiB")
    return sum(kf)


def loop_closing_config():
    """``kitti_rgbl_config()`` as it is — mapping and loop closing on — but
    for the LiDAR extrinsics of the synthetic world."""
    return dataclasses.replace(kitti_synthetic_config(), loop_closing=True)


def render_loop_drive(cfg, device, n_az: int = CLOUD_AZ, n_el: int = CLOUD_EL, seed: int = SEED):
    """Ground truth, images and clouds of the loop drive: a circle of
    ``LOOP_RADIUS`` centred in the closed room, ``LOOP_PERIOD`` frames a lap,
    ``N_LOOP`` frames in all."""
    cam = cfg.camera
    world = syn.make_box_world(seed, tex_size=512, device=device)
    traj = syn.multi_loop_trajectory(N_LOOP, radius=LOOP_RADIUS, period=LOOP_PERIOD)
    traj[:, 4] -= LOOP_RADIUS
    frames = []
    for Twc in traj:
        img = syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy,
                               cam.height, cam.width).contiguous()
        pts = syn.lidar_scan(world, Twc, n_az=n_az, n_el=n_el)
        frames.append((img, pts, torch.ones(pts.shape[0], dtype=torch.bool, device=device)))
    return traj, frames


def kf_centre_errors(m, traj) -> np.ndarray:
    """Distance of every live keyframe's centre from the ground truth of the
    frame that made it (metres)."""
    live = m.valid_kf_ids()
    gt = traj[m.kf_frame_id[live], 4:7] - traj[0, 4:7]
    return np.linalg.norm(lie.np_se3_centers(m.kf_pose[live]) - gt, axis=1)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def spy_loop(rec: dict, traj, prof_ctx, device):
    """For the duration: time every ``LoopCloser.detect_only`` synchronized
    (``rec['detect']``: keyframe, host ms); run a detection that returned an
    event once more from the same state under the profiler (the same event
    must come back); run the correction's ``_search_and_fuse`` under the
    profiler (the two solvers behind it launch ~115,000 kernels, which the
    profiler takes minutes to hand back: they are profiled afterwards, on
    two iterations each); keep the arguments of the last ``optimize_sim3``
    and ``optimize_pose_graph`` and the global BA's snapshot and result; and
    check the binding invariants and the keyframes' distance from ground
    truth after the correction and after the global BA's writeback."""
    orig_detect, orig_apply = LoopCloser.detect_only, LoopCloser.apply_event
    orig_fuse = LoopCloser._search_and_fuse
    orig_iterate, orig_dispatch = LoopCloser._gba_iterate, System._dispatch_gba
    orig_sim3, orig_pg = sim3_opt.optimize_sim3, pose_graph.optimize_pose_graph
    rec.update(detect=[], faults=[], kf_err={}, redetect=[])

    def timed_detect(self, kf_id):
        groups = [(set(g), c) for g, c in self._consistent_groups]
        rng_state = self.generator.get_state()
        _synchronize(device)
        t = time.perf_counter()
        ev = orig_detect(self, kf_id)
        _synchronize(device)
        rec["detect"].append((int(kf_id), (time.perf_counter() - t) * 1e3))
        if ev is not None:
            # once more from the state it started in, under the profiler
            pending = self._pending_fusion
            keep = (self._consistent_groups, self.generator.get_state())
            self._consistent_groups = groups
            self.generator.set_state(rng_state)
            n_kf, n_cand = len(self.stats["keyframes"]), len(self.stats["candidates"])
            with prof_ctx():
                again = orig_detect(self, kf_id)
            rec["redetect"].append((ev, again))
            del self.stats["keyframes"][n_kf:], self.stats["candidates"][n_cand:]
            self._consistent_groups, self._pending_fusion = keep[0], pending
            self.generator.set_state(keep[1])
        return ev

    def timed_apply(self, event):
        rec["kf_err"]["before"] = kf_centre_errors(self.map, traj)
        _synchronize(device)
        t = time.perf_counter()
        orig_apply(self, event)
        _synchronize(device)
        rec["apply_ms"] = (time.perf_counter() - t) * 1e3

    def profiled_fuse(self, event):
        with prof_ctx():
            return orig_fuse(self, event)

    def checked_dispatch(self):
        m = self.loop_closer.map
        rec["faults"].append(("after the correction", map_mod.check_binding_consistency(m)))
        rec["kf_err"]["corrected"] = kf_centre_errors(m, traj)
        orig_dispatch(self)
        rec["faults"].append(("after the global BA's writeback",
                              map_mod.check_binding_consistency(m)))
        rec["kf_err"]["after the global BA"] = kf_centre_errors(m, traj)

    def recorded_iterate(self, snapshot, iterations):
        out = orig_iterate(self, snapshot, iterations)
        rec["gba"] = (snapshot, iterations, out)
        return out

    def recorded_sim3(*a, **k):
        rec["sim3"] = (a, k)
        return orig_sim3(*a, **k)

    def recorded_pg(problem, **k):
        rec["pg"] = (problem, k)
        return orig_pg(problem, **k)

    LoopCloser.detect_only, LoopCloser.apply_event = timed_detect, timed_apply
    LoopCloser._search_and_fuse = profiled_fuse
    LoopCloser._gba_iterate, System._dispatch_gba = recorded_iterate, checked_dispatch
    sim3_opt.optimize_sim3, pose_graph.optimize_pose_graph = recorded_sim3, recorded_pg
    try:
        yield
    finally:
        LoopCloser.detect_only, LoopCloser.apply_event = orig_detect, orig_apply
        LoopCloser._search_and_fuse = orig_fuse
        LoopCloser._gba_iterate, System._dispatch_gba = orig_iterate, orig_dispatch
        sim3_opt.optimize_sim3, pose_graph.optimize_pose_graph = orig_sim3, orig_pg


def timed_without_sync(fn, device):
    """(result, host ms) of ``fn`` run with every wait for the card made an
    error: the three loop solvers must not wait."""
    _synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    t = time.perf_counter()
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue_ms = (time.perf_counter() - t) * 1e3
    _synchronize(device)
    return out, enqueue_ms, (time.perf_counter() - t) * 1e3


def log_loop_spans(what: str, stat):
    busy, n_kernels, by_name, by_span = stat
    log(f"{what} under the profiler: device busy {busy:.2f} ms in {n_kernels} kernels")
    for span in LOOP_SPANS:
        if span in by_span:
            host, sbusy, sn = by_span[span]
            log(f"  span {span:16s} host {host:9.2f} ms  device busy {sbusy:8.3f} ms  kernels {sn}")
    for name, (ms, n_calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"  {ms:8.3f} ms {n_calls:6d} calls  {name[:110]}")


def phase6_loop(cfg, traj, frames, device, kf_every: int):
    """The loop drive with nothing switched off. Returns the System after
    the drive and the drive's record (per-frame results, the event's frame,
    wall time), or None if no loop was closed (the caller may try again with
    forced keyframes)."""
    policy = "the natural keyframe policy" if kf_every == 0 else f"a keyframe forced every {kf_every}"
    n = len(frames)
    prof_ctx, prof_stats = profile_frames("loop.")
    rec, calls, sync_ms, frame_calls, policy_rows, events_at = {}, [], [], [], [], []

    @contextlib.contextmanager
    def on_frame(i):
        calls.clear()
        yield
        frame_calls.append(list(calls))
        events_at.append(len(sysm.loop_closer.events))

    _synchronize(device)
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    sysm = System(cfg, device=device)          # mapping on, loop closing on
    sysm.CLOUD_CAP = frames[0][1].shape[0]
    t_drive = time.perf_counter()
    with spy(calls, sync_ms), spy_loop(rec, traj, prof_ctx, device), spy_kf_policy(policy_rows):
        sysm, results = drive(cfg, frames, device, sysm=sysm, on_frame=on_frame, kf_every=kf_every)
    drive_s = time.perf_counter() - t_drive
    counts = dict(cuda_build.launch_counts)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    m, closer = sysm.map, sysm.loop_closer

    states = [r.state for r, _ in results]
    kf = [r.created_kf for r, _ in results]
    errs = trans_errors(traj, results)
    log(f"loop drive ({policy}): {n} frames in {drive_s:.1f} s, keyframe frames "
        + " ".join(str(i) for i, k in enumerate(kf) if k))
    log("loop drive inliers: " + " ".join(str(r.n_inliers) for r, _ in results[1:]))
    log("loop drive trans err m: " + " ".join(f"{e:.3f}" for e in errs))
    if kf_every == 0:
        log_kf_policy(f"loop drive, {cfg.camera.width}x{cfg.camera.height}, "
                      f"{cfg.orb.n_features} features", policy_rows)
    if any(st != trk.OK for st in states):
        fail(f"loop drive states {[trk.STATE_NAMES[st] for st in states]}: every frame must be OK")
    if not isinstance(closer, LoopCloser) or sysm.mapper is None:
        fail("the loop drive must run with the mapping and the loop-closing plane on")
    if counts["fast_and_blur"] != n or counts["brief_continuous"] != n:
        fail(f"loop drive launch counts {counts} over {n} frames; expected 1 K1 and 1 K2 per frame")
    log("loop plane per keyframe, index + detect host ms (synchronized): "
        + " ".join(f"{k}: {ms:.1f}" for k, ms in rec["detect"]))
    split = closer.stats["keyframes"]
    log("  of which enqueueing the index: "
        + " ".join(f"{s['index_ms']:.1f}" for s in split) + "; detection: "
        + " ".join(f"{s['detect_ms']:.1f}" for s in split))
    if [k for k, _ in rec["detect"]] != list(range(m.n_kf)):
        fail(f"keyframes indexed {[k for k, _ in rec['detect']]}, expected 0..{m.n_kf - 1}")
    for c in closer.stats["candidates"]:
        log(f"loop candidate: keyframe {c['kf']} against {c['cand']}: {c['pairs']} pairs, RANSAC "
            f"{c['ransac']} inliers, refined {c['refined']}, guided {c['guided']} of "
            f"{c['guided_pairs']} pairs, {'accepted' if c['accepted'] else 'rejected'}, "
            f"host {c['ms']:.1f} ms")
    if not closer.events:
        log(f"loop drive ({policy}): {m.n_kf} keyframes, no loop event "
            f"(detection needs 12 keyframes, a gap of {MIN_LOOP_FRAME_GAP} frames and a "
            f"candidate group seen on 4 consecutive keyframes)")
        return None

    # ---- the event ---------------------------------------------------------
    ev, e = closer.events[0], closer.stats["events"][0]
    gap = int(m.kf_frame_id[ev.kf_cur]) - int(m.kf_frame_id[ev.kf_matched])
    fired = events_at.index(1)
    log(f"loop event at frame {fired}: keyframe {ev.kf_cur} (frame {int(m.kf_frame_id[ev.kf_cur])}) "
        f"against keyframe {ev.kf_matched} (frame {int(m.kf_frame_id[ev.kf_matched])}), "
        f"{ev.n_inliers} inliers; {e['fused_search']} landmarks replaced by the projection search "
        f"and {e.get('fused_pairs', 0)} by the verified pairs; essential graph {e['nodes']} nodes, "
        f"{e['edges']} edges, cost {e['pg_cost_before']:.4g} -> {e['pg_cost_after']:.4g} "
        f"({e['pose_graph']}); global BA {e['gba_poses']} poses, {e['gba_landmarks']} landmarks, "
        f"{int(rec['gba'][0][0].obs_mask.sum())} observations, cost {e['gba_cost_before']:.6g} -> "
        f"{e['gba_cost_after']:.6g} ({e['gba']}); events in all: {len(closer.events)}")
    log(f"loop event host ms: fusion {e['fuse_ms']:.1f}, pose graph {e['pose_graph_ms']:.1f}, "
        f"correction in all {e['correct_ms']:.1f}, global BA {e['gba_ms']:.1f}; apply_event "
        f"{rec['apply_ms']:.1f} (synchronized; the fusion ran under the profiler)")
    if gap <= MIN_LOOP_FRAME_GAP:
        fail(f"the loop's keyframes are {gap} frames apart (<= {MIN_LOOP_FRAME_GAP})")
    if e["pose_graph"] != "applied" or not e["pg_cost_after"] < e["pg_cost_before"]:
        fail(f"pose graph {e['pose_graph']}, cost {e['pg_cost_before']} -> {e['pg_cost_after']}")
    if e["gba"] != "applied" or not e["gba_cost_after"] < e["gba_cost_before"]:
        fail(f"global BA {e['gba']}, cost {e['gba_cost_before']} -> {e['gba_cost_after']}")
    for when, faults in rec["faults"]:
        if faults:
            fail(f"check_binding_consistency {when}: {faults}")
    if len(rec["faults"]) < 2:
        fail("the global BA was not dispatched after the correction")
    faults = map_mod.check_binding_consistency(m)
    if faults:
        fail(f"check_binding_consistency at the end of the loop drive: {faults}")
    live = m.valid_kf_ids()
    if not (np.isfinite(m.kf_pose[live]).all() and np.isfinite(m.lm_pos[m.lm_valid]).all()
            and all(np.isfinite(r.pose).all() for r, _ in results)):
        fail("a pose or a landmark of the loop drive is not finite")
    # the motion model still points into the uncorrected map right after the
    # event, so a frame or two may fall to the classic ladder (as in the JAX
    # tracker); from then on every frame is a fused one again
    not_fused = [i for i in range(fired + 1, n) if "_accept_fused" not in frame_calls[i]]
    log(f"frames after the loop event that took the classic ladder: {not_fused or 'none'}")
    if any(i > fired + MAX_CLASSIC_AFTER_LOOP for i in not_fused):
        fail(f"frames {not_fused} after the loop event left the fused step (at most the "
             f"{MAX_CLASSIC_AFTER_LOOP} right after frame {fired} may)")
    first, again = rec["redetect"][0]
    if (first.kf_cur, first.kf_matched, first.n_inliers) != (again.kf_cur, again.kf_matched,
                                                              again.n_inliers):
        fail(f"the detection run again from the same state gave {again}, first {first}")
    log("keyframe centres against ground truth, mean / max m: " + "; ".join(
        f"{when} {v.mean():.3f} / {v.max():.3f}" for when, v in rec["kf_err"].items()))
    log(f"frame poses against ground truth, max m: before the event {errs[:fired].max():.3f}, "
        f"after it {errs[fired + 1:].max():.3f}")
    # ---- the three solvers again: no wait for the card, and the same bits ---
    snapshot, iterations, out = rec["gba"]
    problem, pg_kw = rec["pg"]
    with prof_ctx():
        with record_function("loop.pose_graph"):
            pose_graph.optimize_pose_graph(problem, **{**pg_kw, "iterations": PROFILED_ITERATIONS})
        with record_function("loop.gba"):
            closer._gba_iterate(snapshot, PROFILED_ITERATIONS)
    if len(prof_stats) >= 3 and prof_stats[0][1] > 0:
        log_loop_spans(f"detection of keyframe {ev.kf_cur} (run again from the same state)",
                       prof_stats[0])
        log_loop_spans("the event's fusion", prof_stats[1])
        log_loop_spans(f"{PROFILED_ITERATIONS} of {pg_kw['iterations']} pose-graph iterations and "
                       f"{PROFILED_ITERATIONS} of {iterations} global-BA iterations, on the event's "
                       f"problems", prof_stats[2])
    else:
        log("profiler: no device events recorded for the loop event (not measured)")
    out2, enq, ms = timed_without_sync(lambda: closer._gba_iterate(snapshot, iterations), device)
    res1, res2 = out[2], out2[2]
    same = (torch.equal(res1.poses, res2.poses) and torch.equal(res1.landmarks, res2.landmarks)
            and torch.equal(res1.cost, res2.cost))
    log(f"global BA again on the same snapshot ({iterations} iterations x 64 CG steps): enqueued "
        f"in {enq:.1f} ms, done in {ms:.1f} ms, without a synchronizing call; bit-equal to the "
        f"first solve: {same}")
    if not same:
        fail("a second global BA of the same snapshot is not bit-equal to the first")
    _, enq, ms = timed_without_sync(lambda: pose_graph.optimize_pose_graph(problem, **pg_kw), device)
    K, E = problem.nodes.shape[0], problem.edge_i.shape[0]
    log(f"pose graph again ({K} nodes, {E} edges, {pg_kw}): enqueued in {enq:.1f} ms, done in "
        f"{ms:.1f} ms, without a synchronizing call; the one-hot assembly multiplies "
        f"({E}, {K}) by ({E}, {K * 49}) four times an iteration: {4 * 2 * E * K * K * 49 / 1e6:.1f} "
        f"MFLOP, the dense system is {7 * K} x {7 * K}")
    a, kw = rec["sim3"]
    _, enq, ms = timed_without_sync(lambda: sim3_opt.optimize_sim3(*a, **kw), device)
    log(f"optimize_sim3 again ({a[1].shape[0]} pairs): enqueued in {enq:.1f} ms, done in "
        f"{ms:.1f} ms, without a synchronizing call")
    bound_m = MAX_TRANS_ERR_M * n / N_DRIVE
    if not float(errs[fired + 1:].max()) < bound_m:
        fail(f"translation error after the loop {errs[fired + 1:].max():.3f} m >= {bound_m:.2f} m")
    c = sysm.mapper.counts
    log(f"loop drive ({policy}): {n} frames, {sum(kf)} keyframes created, {live.size} alive, "
        f"{int(m.lm_valid.sum())} landmarks alive, {c['triangulated']} triangulated, "
        f"{c['kf_culled']} keyframes culled; max trans err after the loop "
        f"{errs[fired + 1:].max():.3f} m (bound {bound_m:.2f}); launches {counts}; "
        f"FastPath.sync refreshes {len(sync_ms)}; peak memory {peak_mb:.0f} MiB")
    detect_ms = dict(rec["detect"])[ev.kf_cur]
    return sysm, {"results": results, "fired": fired, "drive_s": drive_s, "peak_mb": peak_mb,
                  "kf_every": kf_every, "event_ms": (detect_ms, rec["apply_ms"])}


def phase6_relocalization(cfg, sysm, frames, device):
    """Textureless frames, then frames of a place the lap mapped: lost, then
    back through relocalization against the keyframe database."""
    n_drive = len(frames)
    blank = torch.full_like(frames[0][0], 12.0)
    seq = ([(blank,) + frames[-1][1:]] * N_RELOC_BLANK
           + frames[RELOC_BACK_TO:RELOC_BACK_TO + N_RELOC_AFTER])
    if not N_RELOC_BLANK < cfg.fps:
        fail(f"{N_RELOC_BLANK} textureless frames would start a new map (fps {cfg.fps})")
    cuda_build.reset_launch_counts()
    reloc_ms = []
    orig = Tracker._relocalization

    def timed_reloc(self, feats):
        _synchronize(device)
        t = time.perf_counter()
        out = orig(self, feats)
        _synchronize(device)
        reloc_ms.append(((time.perf_counter() - t) * 1e3, out[1]))
        return out

    Tracker._relocalization = timed_reloc
    try:
        sysm, res = drive(cfg, seq, device, sysm=sysm, t0=n_drive)
    finally:
        Tracker._relocalization = orig
    counts = dict(cuda_build.launch_counts)
    states = [trk.STATE_NAMES[r.state] for r, _ in res]
    log(f"relocalization states: {' '.join(states)}; inliers "
        + " ".join(str(r.n_inliers) for r, _ in res[N_RELOC_BLANK:])
        + f"; last_reloc_frame {sysm.tracker.last_reloc_frame}; atlas maps {sysm.atlas.n_maps()}; "
        f"launches {counts}")
    log("Tracker._relocalization calls (host ms synchronized, inliers): "
        + " ".join(f"{ms:.1f}:{n_inl}" for ms, n_inl in reloc_ms))
    # the states the JAX System gives on this sequence at 320x192
    expect = ["RECENTLY_LOST"] + ["LOST"] * (N_RELOC_BLANK - 1) + ["OK"] * N_RELOC_AFTER
    if states != expect:
        fail(f"relocalization states {states}, expected {expect}")
    first_back = n_drive + N_RELOC_BLANK
    if sysm.tracker.last_reloc_frame not in (first_back - 1, first_back):
        fail(f"last_reloc_frame {sysm.tracker.last_reloc_frame}: the first textured frame "
             f"(frame {n_drive + N_RELOC_BLANK}) did not relocalize")
    if not any(n_inl >= 30 for _, n_inl in reloc_ms):
        fail("no call of Tracker._relocalization succeeded")
    if sysm.atlas.n_maps() != 1:
        fail(f"{sysm.atlas.n_maps()} atlas maps after relocalization, expected 1")
    if counts["fast_and_blur"] != len(seq) or counts["brief_continuous"] != len(seq):
        fail(f"relocalization launch counts {counts} over {len(seq)} frames")
    traj_out = sysm.trajectory()
    if traj_out.shape != (n_drive + len(seq), 7) or not np.isfinite(traj_out).all():
        fail(f"trajectory() gave {traj_out.shape}, expected ({n_drive + len(seq)}, 7) finite poses")
    faults = map_mod.check_binding_consistency(sysm.map)
    if faults:
        fail(f"check_binding_consistency after relocalization: {faults}")


@contextlib.contextmanager
def spy_weld(rec: dict, device):
    """For the duration: time every ``merging.verify_cross_map``
    (``rec['verify']``: keyframe, candidate, pairs, RANSAC and refined
    inliers, host ms synchronized, the refinement's arguments); time
    ``System._do_merge`` and its weld-window ``local_bundle_adjustment``
    (synchronized); check the binding invariants before and after that BA;
    keep the BA's problem and Huber cost before and after it, the
    ``MergeResult`` and the event with its keyframes' frames."""
    orig_verify, orig_merge = merging.verify_cross_map, merging.merge_maps
    orig_ransac, orig_opt = sim3_opt.sim3_ransac, sim3_opt.optimize_sim3
    orig_do, orig_lba = System._do_merge, LocalMapper.local_bundle_adjustment
    orig_ba = local_ba.bundle_adjust
    rec.update(verify=[])
    inside = {"verify": None, "weld": False}

    def timed_verify(cfg, m1, kf1, m2, kf2, *a, **k):
        cand = {"kf": int(kf1), "cand": int(kf2), "pairs": 0, "ransac": None, "refined": None}
        inside["verify"] = cand
        _synchronize(device)
        t = time.perf_counter()
        try:
            out = orig_verify(cfg, m1, kf1, m2, kf2, *a, **k)
        finally:
            inside["verify"] = None
        _synchronize(device)
        cand.update(ms=(time.perf_counter() - t) * 1e3, accepted=out is not None)
        rec["verify"].append(cand)
        return out

    def recorded_ransac(p1, *a, **k):
        res = orig_ransac(p1, *a, **k)
        if inside["verify"] is not None:
            inside["verify"].update(pairs=int(p1.shape[0]), ransac=res.n_inliers)
        return res

    def recorded_opt(*a, **k):
        out = orig_opt(*a, **k)
        if inside["verify"] is not None:
            inside["verify"].update(refined=out[2], args=(a, k))
        return out

    def recorded_merge(old, active, kf_cur, S):
        res = orig_merge(old, active, kf_cur, S)
        rec["merge"] = (res, int(active.lm_valid.sum()))
        return res

    def timed_do_merge(self, ev):
        rec["event"] = ev
        rec["frames"] = (int(self.map.kf_frame_id[ev.kf_cur]),
                         int(self.atlas.entries[ev.entry_idx].map.kf_frame_id[ev.kf_matched]))
        inside["weld"] = True
        _synchronize(device)
        t = time.perf_counter()
        try:
            orig_do(self, ev)
        finally:
            inside["weld"] = False
        _synchronize(device)
        rec["do_merge_ms"] = (time.perf_counter() - t) * 1e3
        rec["faults_after_ba"] = map_mod.check_binding_consistency(self.map)
        rec["n_maps"] = self.atlas.n_maps()

    def timed_lba(self, kf_id, *a, **k):
        if not inside["weld"]:
            return orig_lba(self, kf_id, *a, **k)
        rec["faults_before_ba"] = map_mod.check_binding_consistency(self.map)
        _synchronize(device)
        t = time.perf_counter()
        out = orig_lba(self, kf_id, *a, **k)
        _synchronize(device)
        rec["lba_ms"] = (time.perf_counter() - t) * 1e3
        return out

    def recorded_ba(problem, cam, **k):
        if not inside["weld"]:
            return orig_ba(problem, cam, **k)
        before = ba_robust_cost(problem, problem.poses, problem.landmarks, cam)
        res = orig_ba(problem, cam, **k)
        rec["ba"] = (problem, cam, k, before,
                     ba_robust_cost(problem, res.poses, res.landmarks, cam))
        return res

    merging.verify_cross_map, merging.merge_maps = timed_verify, recorded_merge
    sim3_opt.sim3_ransac, sim3_opt.optimize_sim3 = recorded_ransac, recorded_opt
    System._do_merge, LocalMapper.local_bundle_adjustment = timed_do_merge, timed_lba
    local_ba.bundle_adjust = recorded_ba
    try:
        yield
    finally:
        merging.verify_cross_map, merging.merge_maps = orig_verify, orig_merge
        sim3_opt.sim3_ransac, sim3_opt.optimize_sim3 = orig_ransac, orig_opt
        System._do_merge, LocalMapper.local_bundle_adjustment = orig_do, orig_lba
        local_ba.bundle_adjust = orig_ba


def phase7_weld(cfg, traj, frames, device, prof_ctx=None):
    """The canyon with nothing switched off: ``N_DRIVE`` frames with a
    keyframe forced every ``KF_EVERY`` (the archived map and its database),
    ``N_BLANK`` textureless frames with the camera held at its last pose (a
    second map starts), then the rest of the path (the revisit: the new
    map's first keyframe is welded into the archived map). With
    ``prof_ctx`` the frames from the first textured one up to the weld run
    under the profiler. Returns (System, per-frame results, the weld's
    frame, rec, frame_calls, ground-truth positions)."""
    blank = torch.full_like(frames[0][0], 12.0)         # textureless: no corners
    seq = (frames[:N_DRIVE] + [(blank,) + frames[N_DRIVE - 1][1:]] * N_BLANK
           + frames[N_DRIVE:])
    gt_idx = list(range(N_DRIVE)) + [N_DRIVE - 1] * N_BLANK + list(range(N_DRIVE, len(frames)))
    rec, calls, frame_calls, weld_at = {}, [], [], []

    @contextlib.contextmanager
    def on_frame(i):
        calls.clear()
        profiled = prof_ctx is not None and i >= N_DRIVE + N_BLANK and "event" not in rec
        with prof_ctx() if profiled else contextlib.nullcontext():
            yield
        frame_calls.append(list(calls))
        if "event" in rec and not weld_at:
            weld_at.append(i)

    _synchronize(device)
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    sysm = System(cfg, device=device)                   # mapping on, loop closing on
    sysm.CLOUD_CAP = frames[0][1].shape[0]
    with spy(calls, []), spy_weld(rec, device):
        sysm, results = drive(cfg, seq, device, sysm=sysm, on_frame=on_frame)
    if not weld_at:
        fail(f"no weld over the revisit: states "
             f"{[trk.STATE_NAMES[r.state] for r, _ in results]}, atlas maps {sysm.atlas.n_maps()}")
    gt_pos = traj[gt_idx, 4:7] - traj[0, 4:7]
    return sysm, results, weld_at[0], rec, frame_calls, gt_pos


def check_weld(cfg, sysm, results, w, rec, frame_calls, gt_pos, device):
    """Phase 7's hard checks on the unprofiled pass, and its report."""
    n = len(results)
    counts = dict(cuda_build.launch_counts)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    states = [trk.STATE_NAMES[r.state] for r, _ in results]
    ev, (res, n_active_lms) = rec["event"], rec["merge"]
    acc = [c for c in rec["verify"] if c["accepted"]][-1]
    s_weld, s12 = float(res.S_w2_w1[7]), float(ev.S12[7])
    losers = np.unique(res.lm_remap[ev.fusion[0]]).size
    log(f"weld drive states: {' '.join(states)}")
    log(f"weld at frame {w}: keyframe {ev.kf_cur} of the new map (frame {rec['frames'][0]}) against "
        f"keyframe {ev.kf_matched} of the archived map (frame {rec['frames'][1]}); "
        f"{acc['pairs']} descriptor pairs -> {int(acc['ransac'])} RANSAC inliers -> "
        f"{int(acc['refined'])} refined; {len(res.appended_kfs)} keyframes and {n_active_lms} "
        f"landmarks transported, {len(ev.fusion[0])} fusion pairs, {losers} duplicates fused; "
        f"scale {s_weld}")
    for c in rec["verify"]:
        log(f"merge candidate: keyframe {c['kf']} against {c['cand']}: {c['pairs']} pairs, "
            f"{'accepted' if c['accepted'] else 'rejected'}, merge.verify host {c['ms']:.1f} ms")
    weld_ms = rec["do_merge_ms"] - rec["lba_ms"]
    log(f"weld host ms (synchronized): merge.verify {acc['ms']:.1f} (the accepted candidate), "
        f"merge.weld {weld_ms:.1f}, merge.ba {rec['lba_ms']:.1f}; the weld's frame "
        f"{results[w][1]:.1f}")
    if states[w:] != ["OK"] * (n - w):
        fail(f"frames after the weld are not all OK: {states[w:]}")
    if rec["n_maps"] != 1 or sysm.atlas.n_maps() != 1:
        fail(f"{sysm.atlas.n_maps()} atlas maps after the weld, expected 1")
    if abs(s_weld - 1.0) > 1e-6 or abs(s12 - 1.0) > 1e-6:
        fail(f"weld scale {s_weld}, S12 scale {s12}: RGB-L fixes the scale at 1")
    for when in ("faults_before_ba", "faults_after_ba"):
        if rec[when]:
            fail(f"check_binding_consistency {when.split('_', 1)[1].replace('_', ' ')}: {rec[when]}")
    problem, cam, kwargs, before, after = rec["ba"]
    before, after = float(before), float(after)
    n_fixed = int((problem.pose_fixed & problem.pose_valid).sum())
    log(f"weld-window BA: {int(problem.pose_valid.sum())} poses ({n_fixed} fixed) in "
        f"{problem.poses.shape[0]} slots, {int(problem.lm_valid.sum())} landmarks, "
        f"{int(problem.obs_mask.sum())} observations, Huber cost {before:.1f} -> {after:.1f}")
    if not (np.isfinite([before, after]).all() and after < before):
        fail(f"the weld-window BA did not lower its Huber cost: {before} -> {after}")
    not_fused = [i for i in range(w + 1, n) if "_accept_fused" not in frame_calls[i]]
    log(f"frames after the weld that took the classic ladder: {not_fused or 'none'}")
    if any(i > w + MAX_CLASSIC_AFTER_WELD for i in not_fused):
        fail(f"frames {not_fused} after the weld left the fused step (at most the "
             f"{MAX_CLASSIC_AFTER_WELD} right after frame {w} may)")
    if counts["fast_and_blur"] != n or counts["brief_continuous"] != n:
        fail(f"weld drive launch counts {counts} over {n} frames; expected 1 K1 and 1 K2 per frame")
    est = sysm.trajectory()
    if est.shape != (n, 7) or not np.isfinite(est).all():
        fail(f"trajectory() gave {est.shape}, expected ({n}, 7) finite poses")
    ok = ~np.asarray(sysm.tracker.traj_lost)
    ate = float(align.ate_rmse(gt_pos[ok], est[ok, 4:7]))
    bound_m = MAX_TRANS_ERR_M * n / N_DRIVE
    log(f"weld drive: {n} frames, {int(ok.sum())} not lost; ATE after Horn alignment {ate:.3f} m "
        f"(bound {bound_m:.2f}); max frame error after the weld "
        f"{np.linalg.norm(est[w:, 4:7] - gt_pos[w:], axis=1).max():.3f} m; "
        f"{sysm.map.n_kf} keyframes, {int(sysm.map.lm_valid.sum())} landmarks in the welded map; "
        f"launches {counts}; peak memory {peak_mb:.0f} MiB")
    if not ate < bound_m:
        fail(f"ATE of the weld drive {ate:.3f} m >= {bound_m:.2f} m")
    # the solvers of the weld once more: no wait for the card
    a, kw = acc["args"]
    _, enq, ms = timed_without_sync(lambda: sim3_opt.optimize_sim3(*a, **kw), device)
    log(f"optimize_sim3 of the weld again ({a[1].shape[0]} pairs): enqueued in {enq:.1f} ms, done "
        f"in {ms:.1f} ms, without a synchronizing call")
    _, enq, ms = timed_without_sync(lambda: local_ba.bundle_adjust(problem, cam, **kwargs), device)
    log(f"weld-window bundle_adjust again: enqueued in {enq:.1f} ms, done in {ms:.1f} ms, without "
        f"a synchronizing call")
    return (w, ev.kf_cur, ev.kf_matched, acc["pairs"], int(acc["ransac"]), int(acc["refined"]))


def phase7(cfg, traj, frames, device):
    """The weld drive twice: once unprofiled (the checks and the host
    times), once with the revisit's frames under the profiler (device time
    and kernels by ``merge.*`` span); both must weld alike."""
    t0 = time.perf_counter()
    sysm, results, w, rec, frame_calls, gt_pos = phase7_weld(cfg, traj, frames, device)
    first = check_weld(cfg, sysm, results, w, rec, frame_calls, gt_pos, device)
    sysm.shutdown()
    del sysm
    log(f"phase 7 weld drive: {time.perf_counter() - t0:.1f} s")
    prof_ctx, prof_stats = profile_frames("merge.")
    sysm, results, w, rec, _, _ = phase7_weld(cfg, traj, frames, device, prof_ctx)
    sysm.shutdown()
    acc = [c for c in rec["verify"] if c["accepted"]][-1]
    again = (w, rec["event"].kf_cur, rec["event"].kf_matched, acc["pairs"], int(acc["ransac"]),
             int(acc["refined"]))
    log(f"the weld drive again, the revisit under the profiler: weld (frame, keyframes, pairs, "
        f"RANSAC and refined inliers) {again}, the first pass's {first}: same {again == first}")
    if prof_stats and prof_stats[-1][1] > 0:
        busy, n_kernels, by_name, by_span = prof_stats[-1]
        log(f"the weld's frame under the profiler: device busy {busy:.2f} ms in {n_kernels} kernels")
        for span in merging.MERGE_SPANS:
            if span in by_span:
                host, sbusy, sn = by_span[span]
                log(f"  span {span:14s} host {host:9.2f} ms  device busy {sbusy:8.3f} ms  kernels {sn}")
        for name, (ms, n_calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            log(f"  {ms:8.3f} ms {n_calls:6d} calls  {name[:110]}")
    else:
        log("profiler: no device events recorded for the weld's frame (not measured)")


def recall_at_3(db, m, traj) -> tuple:
    """Retrieval on a frozen map (tests/test_tree_vocab_e2e.py's measure):
    the share of keyframes of the revisit stretch whose top 3 candidates
    more than ``MIN_LOOP_FRAME_GAP`` frames older hold one within 3 m, and
    the number of such queries."""
    hits, total = 0, 0
    live = m.valid_kf_ids()
    for k in live:
        fid = int(m.kf_frame_id[k])
        if not REVISIT_FROM <= fid < len(traj):
            continue
        total += 1
        scores, _ = db.query(db.vectors[k], np.asarray([k], np.int64))
        elig = np.zeros_like(scores, bool)
        elig[live] = fid - m.kf_frame_id[live] > MIN_LOOP_FRAME_GAP
        scores = np.where(elig, scores, 0.0)
        for c in np.argsort(-scores)[:3]:
            if scores[c] > 0 and np.linalg.norm(traj[int(m.kf_frame_id[c]), 4:7]
                                                - traj[fid, 4:7]) < 3.0:
                hits += 1
                break
    return hits / max(total, 1), total


def phase8_vocabulary(cfg, loop_sys, traj, frames, device):
    """The trained tree vocabulary: trained on phase 6's map, its recall@3
    beside the LSH words' on that frozen map, saved to ``VOCAB_PATH``; one
    ``bow`` of a frame at KITTI size timed and profiled."""
    m = loop_sys.map
    kfs = m.valid_kf_ids()
    docs = [m.kf_desc[k][m.kf_feat_valid[k]] for k in kfs]
    t = time.perf_counter()
    voc = train_vocabulary(np.concatenate(docs), k=VOCAB_K, depth=VOCAB_DEPTH, seed=0,
                           idf_docs=docs, device=device)
    train_s = time.perf_counter() - t
    recall_lsh, n_q = recall_at_3(loop_sys.loop_closer.db, m, traj)
    db = KeyFrameDatabase(m.capacity_kf, vocabulary=voc, device=device)
    for k in kfs:
        db.add(int(k), m.kf_desc[k], m.kf_feat_valid[k])
    recall_tree, _ = recall_at_3(db, m, traj)
    log(f"tree vocabulary k={VOCAB_K} depth={VOCAB_DEPTH} ({voc.n_words} words) trained on "
        f"{sum(len(d) for d in docs)} descriptors of {len(kfs)} keyframes in {train_s:.1f} s; "
        f"checksum {voc.checksum()}; recall@3 on the frozen map: LSH {recall_lsh:.2f}, tree "
        f"{recall_tree:.2f} ({n_q} queries)")
    if n_q < 3:
        fail(f"{n_q} revisit keyframes to query (< 3)")
    if recall_tree < MIN_TREE_RECALL or recall_tree < recall_lsh - MAX_RECALL_GAP:
        fail(f"tree recall@3 {recall_tree:.2f} (LSH {recall_lsh:.2f}): needs >= {MIN_TREE_RECALL} "
             f"and >= LSH - {MAX_RECALL_GAP}")
    os.makedirs(os.path.dirname(VOCAB_PATH), exist_ok=True)
    voc.save(VOCAB_PATH)
    # one bow of a frame at KITTI size
    o, cam = cfg.orb, cfg.camera
    f = frame_mod.extract_features(frames[0][0], cam.height, cam.width, n_features=o.n_features,
                                   n_levels=o.n_levels, scale_factor=o.scale_factor,
                                   ini_th=float(o.ini_th_fast), min_th=float(o.min_th_fast),
                                   device=device)
    ms = []
    for _ in range(11):
        _synchronize(device)
        t = time.perf_counter()
        voc.bow(f.desc, f.valid)
        _synchronize(device)
        ms.append((time.perf_counter() - t) * 1e3)
    busy = kernel_device_ms(lambda: voc.bow(f.desc, f.valid), "", iters=5)
    with _profile() as prof:
        voc.bow(f.desc, f.valid)
        torch.cuda.synchronize()
    n_kernels = sum(1 for e in prof.events() if _on_device(e))
    log(f"TreeVocabulary.bow of one frame ({f.desc.shape[0]} descriptor slots, "
        f"{int(f.valid.sum())} valid): host ms synchronized median {statistics.median(ms[1:]):.3f}; "
        f"device busy {busy:.4f} ms in {n_kernels} kernels")
    return VOCAB_PATH


def phase8_vocab_drive(cfg, traj, frames, path, device):
    """Phase 6's forced pass once more with ``vocab_path`` set: the database
    scores with the trained tree vocabulary and must close the loop."""
    cfg = dataclasses.replace(cfg, vocab_path=path)
    n = len(frames)
    _synchronize(device)
    cuda_build.reset_launch_counts()
    sysm = System(cfg, device=device)
    sysm.CLOUD_CAP = frames[0][1].shape[0]
    t = time.perf_counter()
    sysm, results = drive(cfg, frames, device, sysm=sysm, kf_every=KF_EVERY)
    drive_s = time.perf_counter() - t
    sysm.shutdown()
    counts = dict(cuda_build.launch_counts)
    m, closer = sysm.map, sysm.loop_closer
    states = [trk.STATE_NAMES[r.state] for r, _ in results]
    events = [(ev.kf_cur, ev.kf_matched, int(m.kf_frame_id[ev.kf_cur]),
               int(m.kf_frame_id[ev.kf_matched]), ev.n_inliers) for ev in closer.events]
    est = sysm.trajectory()
    ate = float(align.ate_rmse(traj[:n, 4:7] - traj[0, 4:7], est[:, 4:7]))
    bound_m = MAX_TRANS_ERR_M * n / N_DRIVE
    log(f"vocab_path drive (a keyframe forced every {KF_EVERY}): {n} frames in {drive_s:.1f} s, "
        f"{m.n_kf} keyframes; loop events (keyframes, frames, inliers) {events}; ATE {ate:.3f} m "
        f"(bound {bound_m:.2f}); launches {counts}")
    if closer.db.vocabulary is None:
        fail("vocab_path did not reach the keyframe database")
    if any(st != "OK" for st in states):
        fail(f"vocab_path drive states {states}: every frame must be OK")
    if not any(fc - fm > MIN_LOOP_FRAME_GAP for _, _, fc, fm, _ in events):
        fail(f"the vocab_path drive closed no loop over more than {MIN_LOOP_FRAME_GAP} frames: "
             f"{events}")
    if counts["fast_and_blur"] != n or counts["brief_continuous"] != n:
        fail(f"vocab_path drive launch counts {counts} over {n} frames")
    if not ate < bound_m:
        fail(f"ATE of the vocab_path drive {ate:.3f} m >= {bound_m:.2f} m")


def _median_p90(ms) -> str:
    if not ms:
        return "no frames"
    p90 = statistics.quantiles(ms, n=10)[-1] if len(ms) > 1 else ms[0]
    return f"{len(ms)} frames, median {statistics.median(ms):.2f} p90 {p90:.2f}"


def phase9_async(cfg, traj, frames, device, sync_run):
    """Phase 6's forced pass again with ``async_mapping = True``: the
    mapping, loop and GBA workers on their threads and CUDA streams. Hard
    checks, then per-kind host ms beside the synchronous pass's on the same
    frames (``sync_run``, phase 6's record in this call)."""
    n = len(frames)
    kf_every = sync_run["kf_every"] or KF_EVERY
    tracker_stream = torch.cuda.current_stream(device)
    now = {"frame": -1}
    spans = {"mapping": [], "loop": [], "gba": []}     # (thread, stream, t0, t1)
    marks = {"detected": [], "applied": [], "gba_landed": []}
    frame_span = {}
    orig = {"job": System._mapping_job, "detect": LoopCloser.detect_only,
            "iterate": LoopCloser._gba_iterate, "apply": LoopCloser.apply_event,
            "apply_gba": LoopCloser._apply_gba}

    def timed(plane, fn, on_out=None):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spans[plane].append((threading.current_thread().name,
                                 torch.cuda.current_stream(device), t0, time.perf_counter()))
            if on_out is not None:
                on_out(out)
            return out
        return wrapper

    def job(self, kf_id, defer_merge):
        return timed("mapping", orig["job"])(self, kf_id, defer_merge)

    def apply_event(self, ev):
        t0 = time.perf_counter()
        out = orig["apply"](self, ev)
        marks["applied"].append((now["frame"], threading.current_thread().name,
                                 round((time.perf_counter() - t0) * 1e3, 1)))
        return out

    def apply_gba(self, out):
        ok = orig["apply_gba"](self, out)
        marks["gba_landed"].append((now["frame"], threading.current_thread().name, ok))
        return ok

    @contextlib.contextmanager
    def on_frame(i):
        now["frame"] = i
        t0 = time.perf_counter()
        yield
        frame_span[i] = (t0, time.perf_counter())

    _synchronize(device)
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    sysm = System(cfg, device=device)
    sysm.CLOUD_CAP = frames[0][1].shape[0]
    sysm.async_mapping = True
    System._mapping_job = job
    LoopCloser.detect_only = timed("loop", orig["detect"], lambda ev: ev is not None and marks[
        "detected"].append((now["frame"], round((spans["loop"][-1][3] - spans["loop"][-1][2])
                                                * 1e3, 1))))
    LoopCloser._gba_iterate = timed("gba", orig["iterate"])
    LoopCloser.apply_event, LoopCloser._apply_gba = apply_event, apply_gba
    try:
        t_drive = time.perf_counter()
        sysm, results = drive(cfg, frames, device, sysm=sysm, on_frame=on_frame,
                              kf_every=kf_every)
        drive_s = time.perf_counter() - t_drive
        now["frame"] = "shutdown"
        t_shut = time.perf_counter()
        sysm.shutdown()
        shutdown_ms = (time.perf_counter() - t_shut) * 1e3
    finally:
        System._mapping_job = orig["job"]
        LoopCloser.detect_only, LoopCloser._gba_iterate = orig["detect"], orig["iterate"]
        LoopCloser.apply_event, LoopCloser._apply_gba = orig["apply"], orig["apply_gba"]
    counts = dict(cuda_build.launch_counts)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    m, closer = sysm.map, sysm.loop_closer
    states = [r.state for r, _ in results]
    kf = [r.created_kf for r, _ in results]
    log(f"async loop drive (a keyframe forced every {kf_every}): {n} frames in {drive_s:.1f} s "
        f"(+ {shutdown_ms:.0f} ms of shutdown), keyframe frames "
        + " ".join(str(i) for i, k in enumerate(kf) if k))

    # ---- hard checks ----------------------------------------------------------
    if any(st != trk.OK for st in states):
        fail(f"async loop drive states {[trk.STATE_NAMES[st] for st in states]}: every frame "
             f"must be OK")
    if sysm.worker_errors:
        fail(f"{len(sysm.worker_errors)} worker errors; the first:\n{sysm.worker_errors[0]}")
    if counts["fast_and_blur"] != n or counts["brief_continuous"] != n:
        fail(f"async loop drive launch counts {counts} over {n} frames; expected 1 K1 and 1 K2 "
             f"per frame")
    jobs = spans["mapping"]
    if not jobs or any(not t.startswith("mapping") or st == tracker_stream
                       for t, st, _, _ in jobs):
        fail(f"mapping jobs ran on {sorted({(t, st.cuda_stream) for t, st, _, _ in jobs})}; "
             f"expected the mapping thread, on a stream other than the tracker's "
             f"({tracker_stream.cuda_stream})")
    loops = [ev for ev in closer.events
             if int(m.kf_frame_id[ev.kf_cur]) - int(m.kf_frame_id[ev.kf_matched])
             > MIN_LOOP_FRAME_GAP]
    if not loops:
        fail(f"no loop event with keyframes more than {MIN_LOOP_FRAME_GAP} frames apart "
             f"(events {[(e.kf_cur, e.kf_matched) for e in closer.events]})")
    gba_threads = {t for t, _, _, _ in spans["gba"]}
    landed = [mk for mk in marks["gba_landed"] if mk[2]]
    if gba_threads != {"gba_0"} or not landed:
        fail(f"global BA ran on {gba_threads}, writebacks {marks['gba_landed']}; expected the gba "
             f"thread and an applied writeback")
    faults = map_mod.check_binding_consistency(m)
    if faults:
        fail(f"check_binding_consistency after the async drive's shutdown: {faults}")
    est = sysm.trajectory()
    ate = float(align.ate_rmse(traj[:, 4:7] - traj[0, 4:7], est[:, 4:7]))
    bound_m = MAX_TRANS_ERR_M * n / N_DRIVE
    if not (est.shape == (n, 7) and np.isfinite(est).all() and ate < bound_m):
        fail(f"async loop drive trajectory {est.shape}, ATE {ate:.3f} m (bound {bound_m:.2f})")

    # ---- what it gave back ----------------------------------------------------
    ev = loops[0]
    ev_frame = int(m.kf_frame_id[ev.kf_cur])
    busy = [(t0, t1) for plane in spans.values() for _, _, t0, t1 in plane]

    def overlaps(i):
        f0, f1 = frame_span[i]
        return any(t0 < f1 and t1 > f0 for t0, t1 in busy)

    timed_frames = range(2, n)
    a_ms = [ms for _, ms in results]
    s_res, s_fired = sync_run["results"], sync_run["fired"]
    s_ms = [ms for _, ms in s_res]
    s_kf = [r.created_kf for r, _ in s_res]
    plain = [i for i in timed_frames if not kf[i] and i != ev_frame]
    log(f"phase 9 host ms/frame, async | synchronous (phase 6's pass, a keyframe forced every "
        f"{sync_run['kf_every'] or KF_EVERY}, same frames, this call):")
    log(f"  no keyframe: {_median_p90([a_ms[i] for i in plain])} | "
        f"{_median_p90([s_ms[i] for i in timed_frames if not s_kf[i] and i != s_fired])}")
    log(f"  keyframe: {_median_p90([a_ms[i] for i in timed_frames if kf[i] and i != ev_frame])} | "
        f"{_median_p90([s_ms[i] for i in timed_frames if s_kf[i] and i != s_fired])}")
    log(f"  the event keyframe's frame: {a_ms[ev_frame]:.1f} (frame {ev_frame}) | "
        f"{s_ms[s_fired]:.1f} (frame {s_fired}, with phase 6's profiled second detection; "
        f"synchronized index + detection {sync_run['event_ms'][0]:.1f} and apply_event "
        f"{sync_run['event_ms'][1]:.1f} of it)")
    over = [i for i in plain if overlaps(i)]
    alone = [i for i in plain if not overlaps(i)]
    log(f"  no keyframe, overlapping a worker's job: {_median_p90([a_ms[i] for i in over])}; "
        f"with no job running: {_median_p90([a_ms[i] for i in alone])}")
    log(f"  drive wall time {drive_s:.1f} s | {sync_run['drive_s']:.1f} s; peak memory "
        f"{peak_mb:.0f} MiB | {sync_run['peak_mb']:.0f} MiB")
    shed = sum(k["index_only"] for k in closer.stats["keyframes"])
    log(f"async planes: {len(spans['mapping'])} mapping jobs (host ms median "
        f"{statistics.median([(t1 - t0) * 1e3 for _, _, t0, t1 in jobs]):.1f}), "
        f"{len(spans['loop'])} detections ({shed} index only, shed), "
        f"{len(spans['gba'])} global-BA solves; busy-gate deferrals (deferred_kf) "
        f"{sysm.tracker.deferred_kf}; streams: tracker {tracker_stream.cuda_stream}, mapping "
        f"{jobs[0][1].cuda_stream}, loop "
        f"{spans['loop'][0][1].cuda_stream if spans['loop'] else '-'}, gba "
        f"{spans['gba'][0][1].cuda_stream if spans['gba'] else '-'}")
    log(f"async loop event: keyframe {ev.kf_cur} (frame {ev_frame}) against {ev.kf_matched} "
        f"(frame {int(m.kf_frame_id[ev.kf_matched])}), {ev.n_inliers} inliers; detected during "
        f"(frame, detection ms) {marks['detected']}, applied during (frame, thread, ms) "
        f"{marks['applied']}, the global BA landed at {marks['gba_landed']} (frame, thread, "
        f"applied) after a solve of {(spans['gba'][-1][3] - spans['gba'][-1][2]) * 1e3:.1f} ms "
        f"on its thread; events in all "
        f"{len(closer.events)}; ATE {ate:.3f} m (bound {bound_m:.2f}); {m.n_kf} keyframes, "
        f"{len(m.valid_kf_ids())} alive, {int(m.lm_valid.sum())} landmarks; launches {counts}")


N_UPSAMPLE = 21    # phase 10: frames of phase 2's drive per upsampling method


def phase10_upsamplers(cfg, traj, frames, device, id_depth_span):
    """The fused step with the paper's two other LiDAR upsamplers: phase 2's
    first frames per method, mapping off, a keyframe forced every 4. Hard
    checks as phase 2's; the share of valid keypoints with depth beside
    InverseDilation's on the same keypoints, and ``track.depth`` under the
    profiler on the last frame beside phase 2's (``id_depth_span``)."""
    n = N_UPSAMPLE
    bound = MAX_TRANS_ERR_M * n / N_DRIVE
    cam, lc = cfg.camera, cfg.lidar
    P = lidar_projection(cfg, device)
    for method in ("AverageFiltering", "NearestNeighborPixel"):
        mcfg = dataclasses.replace(cfg, lidar=dataclasses.replace(lc, method=method))
        prof_ctx, prof_stats = profile_frames()
        calls, sync_ms, frame_calls, steps = [], [], [], []
        run = FastPath.run

        def recorded_run(self, img, points, cloud_valid, Tcw_pred):
            out = run(self, img, points, cloud_valid, Tcw_pred)
            steps.append((points, cloud_valid, out.feats))
            return out

        @contextlib.contextmanager
        def on_frame(i):
            calls.clear()
            with prof_ctx() if i == n - 1 else contextlib.nullcontext():
                yield
            frame_calls.append(list(calls))

        cuda_build.reset_launch_counts()
        FastPath.run = recorded_run
        try:
            with spy(calls, sync_ms):
                _, results = drive(mcfg, frames[:n], device, on_frame=on_frame)
        finally:
            FastPath.run = run
        counts = dict(cuda_build.launch_counts)
        states = [r.state for r, _ in results]
        inliers = [r.n_inliers for r, _ in results[1:]]
        fused = ["_accept_fused" in c for c in frame_calls]
        errs = trans_errors(traj, results)
        if any(st != trk.OK for st in states) or min(inliers) < MIN_INLIERS:
            fail(f"{method}: states {[trk.STATE_NAMES[st] for st in states]}, inliers {inliers}; "
                 f"every frame must be OK with >= {MIN_INLIERS}")
        if not all(fused[2:]):
            fail(f"{method}: fused frames {[i for i, f in enumerate(fused) if f]}; expected 2..{n - 1}")
        if counts["fast_and_blur"] != n or counts["brief_continuous"] != n:
            fail(f"{method}: launch counts {counts} over {n} frames; expected 1 K1 and 1 K2 a frame")
        if not float(errs.max()) < bound:
            fail(f"{method}: translation error {errs.max():.3f} m >= {bound:.3f} m")
        with_depth, id_depth, valid = [], [], []
        for points, cloud_valid, f in steps:
            d_id, _, _ = depth_ops.compute_depth_from_pointcloud(
                points, P, f.uv, f.uv, height=cam.height, width=cam.width, bf=cam.bf,
                method="InverseDilation", min_dist=lc.min_dist, max_dist=lc.max_dist,
                dil_kind=lc.dil_kernel_type, dil_ku=lc.dil_kernel_size_u,
                dil_kv=lc.dil_kernel_size_v, valid_mask=cloud_valid)
            v = f.valid
            valid.append(int(v.sum()))
            with_depth.append(int(((f.depth > 0) & v).sum()))
            id_depth.append(int(((d_id > 0) & v).sum()))
        share = sum(with_depth) / sum(valid)
        share_id = sum(id_depth) / sum(valid)
        depth_spans = [st[3].get("track.depth") for st in prof_stats if st[1] > 0]
        log(f"{method}: {n} frames, all OK, fused from frame 2, launches {counts}, max trans err "
            f"{errs.max():.3f} m (bound {bound:.3f}); valid keypoints with depth {share:.4f} "
            f"against InverseDilation's {share_id:.4f} on the same keypoints "
            f"({len(steps)} fused steps); host ms/frame fused "
            f"{_median_p90([ms for i, (_, ms) in enumerate(results) if fused[i]])}")
        if depth_spans:
            log(f"  track.depth under the profiler, host ms / device busy ms / kernels: "
                + "; ".join(f"{h:.2f} / {b:.3f} / {k}" for h, b, k in depth_spans)
                + f" (InverseDilation, phase 2: {id_depth_span[0]:.2f} / {id_depth_span[1]:.3f} / "
                  f"{id_depth_span[2]})")
        else:
            log(f"  {method}: profiler recorded no device events (track.depth not measured)")


def long_mapping_drive(cfg, device, n_frames: int):
    """``--mapping-drive N``: N frames of the canyon (the far wall stands
    120 m ahead: N ≤ 161), tracking only and then with the mapping plane
    on, a keyframe forced every ``KF_EVERY`` frames in both: how the
    window and the map grow with and without culling over a longer drive
    than phase 5's. The error bound is ``MAX_TRANS_ERR_M``, which was set
    for ``N_DRIVE`` frames, scaled with the number of frames: drift grows
    with the distance driven."""
    traj, frames = render_drive(cfg, n_frames, device)
    windows = []
    sysm = System(cfg, enable_mapping=False, device=device)
    sysm.CLOUD_CAP = frames[0][1].shape[0]

    @contextlib.contextmanager
    def on_frame(i):
        yield
        windows.append(len(sysm._fast.win_ids) if sysm._fast else 0)

    sysm, results = drive(cfg, frames, device, sysm=sysm, on_frame=on_frame)
    if any(r.state != trk.OK for r, _ in results):
        fail("a frame of the long tracking-only drive is not OK")
    ms = [t for i, (r, t) in enumerate(results) if i > 1 and not r.created_kf]
    log(f"long tracking-only drive: {n_frames} frames, {sysm.map.n_kf} keyframes, host ms/frame "
        f"without a keyframe median {statistics.median(ms):.2f}")
    tracking_only = {"windows": windows, "landmarks": int(sysm.map.lm_valid.sum()),
                     "max_err": float(trans_errors(traj, results).max())}
    del sysm
    phase5_mapping(cfg, frames, traj, device, KF_EVERY, tracking_only,
                   max_err=MAX_TRANS_ERR_M * n_frames / N_DRIVE)


def main():
    # the script drives one card: unless the caller chose the visible
    # cards, show it only the first (before CUDA is first touched)
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    device = torch.device("cuda")
    card = gpu_name_and_power_limit()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch.backends.cuda.matmul.allow_tf32 = False; torch.backends.cudnn.allow_tf32 = False")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- phase 0: build ----------------------------------------------------
    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    log(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, text in cuda_build.ptxas_log.items():
        for line in text.splitlines():
            if "ptxas" in line or "Used" in line:
                log(f"  [{name}] {line.strip()}")
    sass = sass_counts(paths["frontend"], "fast_blur_kernel")
    if sass is None:
        log("cuobjdump not found: K1's machine code not counted")
    else:
        log(f"K1 machine code (staging, padding fill and 8 unrolled rows of 32 pixels a "
            f"warp): {sum(sass.values())} SASS lines; " + ", ".join(f"{op} {n}" for op, n in sass.most_common(14)))

    for kernel, what in (("brief_kernel", "K2"), ("brief_binned_kernel", "K3")):
        sass = sass_counts(paths["brief"], kernel)
        if sass is not None:
            log(f"{what} machine code ({kernel}): {sum(sass.values())} SASS lines; "
                + ", ".join(f"{op} {n}" for op, n in sass.most_common(12)))

    cfg = kitti_synthetic_config()
    if "--mapping-drive" in sys.argv[1:]:
        long_mapping_drive(cfg, device, int(sys.argv[sys.argv.index("--mapping-drive") + 1]))
        log(card)
        return

    # ---- phase 1: kernels against plain versions ----------------------------
    k = phase1_kernels(cfg, device)

    # ---- phase 2: the main path ---------------------------------------------
    n_total = N_DRIVE + N_BLANK + N_AFTER
    t0 = time.perf_counter()
    traj, frames = render_drive(cfg, n_total, device)
    torch.cuda.synchronize()
    log(f"rendered {n_total} frames at {cfg.camera.width}x{cfg.camera.height} with "
        f"{frames[0][1].shape[0]}-point clouds in {time.perf_counter() - t0:.1f} s")
    prof_ctx, prof_stats = profile_frames()
    calls, sync_ms, frame_calls = [], [], []

    windows2 = []
    sysm = System(cfg, enable_mapping=False, device=device)
    sysm.CLOUD_CAP = frames[0][1].shape[0]

    @contextlib.contextmanager
    def on_frame(i):
        calls.clear()
        with prof_ctx() if i >= N_DRIVE - N_PROFILED else contextlib.nullcontext():
            yield
        frame_calls.append(list(calls))
        windows2.append(len(sysm._fast.win_ids) if sysm._fast else 0)

    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    with spy(calls, sync_ms), count_calls(brief_cuda, "continuous_index_tables") as table_calls:
        sysm, results = drive(cfg, frames[:N_DRIVE], device, sysm=sysm, on_frame=on_frame)
    counts = dict(cuda_build.launch_counts)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    kf0_lms = int((sysm.map.kf_lm_idx[0] >= 0).sum())
    window = len(sysm._fast.win_ids)

    states = [r.state for r, _ in results]
    fused = ["_accept_fused" in c for c in frame_calls]
    kf = [r.created_kf for r, _ in results]
    inliers = [r.n_inliers for r, _ in results[1:]]
    errs = trans_errors(traj, results)
    log("frame inliers: " + " ".join(str(n) for n in inliers))
    log("keyframe frames: " + " ".join(str(i) for i, k in enumerate(kf) if k))
    log("trans err m: " + " ".join(f"{e:.3f}" for e in errs))
    if any(st != trk.OK for st in states):
        fail(f"states {[trk.STATE_NAMES[st] for st in states]}: every frame must be OK")
    if frame_calls[1][:1] != ["_track_reference_keyframe"] or frame_calls[1][-1] != "_track_local_map":
        fail(f"frame 1 ran {frame_calls[1]}; expected TrackReferenceKeyFrame then TrackLocalMap")
    if fused[:2] != [False, False] or not all(fused[2:]):
        fail(f"fused frames {[i for i, f in enumerate(fused) if f]}; expected frames 2..{N_DRIVE - 1}")
    if sysm.map.n_kf < MIN_KEYFRAMES:
        fail(f"{sysm.map.n_kf} keyframes (< {MIN_KEYFRAMES})")
    if min(inliers) < MIN_INLIERS:
        fail(f"a tracked frame kept {min(inliers)} inliers (< {MIN_INLIERS})")
    if counts["fast_and_blur"] != N_DRIVE or counts["brief_continuous"] != N_DRIVE:
        fail(f"launch counts {counts} over {N_DRIVE} frames; expected 1 K1 and 1 K2 per frame")
    if table_calls[0] != 0:
        fail(f"continuous_index_tables ran {table_calls[0]} times on the main path; K2 rotates "
             f"its own pattern")
    if not window > kf0_lms:
        fail(f"window of {window} landmarks did not grow past keyframe 0's {kf0_lms}")
    if not float(errs.max()) < MAX_TRANS_ERR_M:
        fail(f"translation error {errs.max():.3f} m >= {MAX_TRANS_ERR_M} m")
    timed = range(1, N_DRIVE - N_PROFILED)
    kinds = {"classic": [i for i in timed if not fused[i]],
             "fused, no keyframe": [i for i in timed if fused[i] and not kf[i]],
             "fused + keyframe": [i for i in timed if fused[i] and kf[i]]}
    for kind, idx in kinds.items():
        ms = [results[i][1] for i in idx]
        p90 = statistics.quantiles(ms, n=10)[-1] if len(ms) > 1 else ms[0]
        log(f"host ms/frame, {kind}: {len(ms)} frames, median {statistics.median(ms):.2f} "
            f"p90 {p90:.2f}, all {' '.join(f'{m:.1f}' for m in ms)}")
    log(f"FastPath.sync refreshes: {len(sync_ms)}, host ms median "
        f"{statistics.median(sync_ms):.2f} max {max(sync_ms):.2f}")
    log(f"main path: {N_DRIVE} frames, {sysm.map.n_kf} keyframes, {int(sysm.map.lm_valid.sum())} "
        f"landmarks; window {window} landmarks at the end (keyframe 0 made {kf0_lms}); "
        f"launches {counts} (1 K1 and 1 K2 per frame); max trans err {errs.max():.3f} m "
        f"(bound {MAX_TRANS_ERR_M}); peak memory {peak_mb:.0f} MiB")
    if prof_stats and prof_stats[0][1] > 0:
        log(f"profiler (frames {N_DRIVE - N_PROFILED}..{N_DRIVE - 1}, keyframe "
            f"{kf[N_DRIVE - N_PROFILED:]}): device busy ms/frame "
            f"{', '.join(f'{s[0]:.2f}' for s in prof_stats)}; kernels/frame "
            f"{', '.join(str(s[1]) for s in prof_stats)}")
        for span, (host, busy, n) in sorted(prof_stats[0][3].items()):
            log(f"  span {span:20s} host {host:8.2f} ms  device busy {busy:7.3f} ms  kernels {n}")
        n_extract = prof_stats[0][3]["track.extract"][2]
        if n_extract > MAX_EXTRACT_KERNELS:
            fail(f"track.extract ran {n_extract} kernels (> {MAX_EXTRACT_KERNELS})")
        for name, (ms, n_calls) in sorted(prof_stats[0][2].items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"  {ms:8.3f} ms {n_calls:6d} calls  {name[:110]}")
    else:
        log("profiler: no device events recorded (device busy time not measured)")
    no_kf = max(i for i in timed if fused[i] and not kf[i])
    check_no_sync(sysm.tracker, frames[no_kf], device)
    tracking_only = {"windows": windows2, "landmarks": int(sysm.map.lm_valid.sum()),
                     "max_err": float(errs.max())}

    # ---- phase 3: the lost states and a second atlas map ------------------
    cuda_build.reset_launch_counts()
    blank = torch.full_like(frames[0][0], 12.0)       # textureless: no corners
    lost_frames = [(blank if i < N_DRIVE + N_BLANK else img, pts, mask)
                   for i, (img, pts, mask) in enumerate(frames) if i >= N_DRIVE]
    sysm, lost = drive(cfg, lost_frames, device, sysm=sysm, t0=N_DRIVE)
    counts3 = dict(cuda_build.launch_counts)
    states3 = [trk.STATE_NAMES[r.state] for r, _ in lost]
    log(f"lost phase states: {' '.join(states3)}; atlas maps {sysm.atlas.n_maps()}; "
        f"launches {counts3}")
    expect = (["RECENTLY_LOST"] + ["LOST"] * (N_BLANK - 1) + ["OK"] * N_AFTER)
    if states3 != expect:
        fail(f"lost phase states {states3}, expected {expect}")
    if sysm.atlas.n_maps() != 2:
        fail(f"{sysm.atlas.n_maps()} atlas maps after the lost streak, expected 2")
    n3 = N_BLANK + N_AFTER
    if counts3["fast_and_blur"] != n3 or counts3["brief_continuous"] != n3:
        fail(f"lost phase launch counts {counts3} over {n3} frames; expected 1 K1 and 1 K2 per frame")
    traj_out = sysm.trajectory()
    if traj_out.shape != (n_total, 7) or not np.isfinite(traj_out).all():
        fail(f"trajectory() gave {traj_out.shape}, expected ({n_total}, 7) finite poses")
    log(f"trajectory(): {traj_out.shape[0]} poses for {n_total} frames over 2 atlas maps")

    # ---- phase 4: binned BRIEF (K3) ----------------------------------------
    cam, o = cfg.camera, cfg.orb

    def extract(img, mode):
        return frame_mod.extract_features(
            img, cam.height, cam.width, n_features=o.n_features, n_levels=o.n_levels,
            scale_factor=o.scale_factor, ini_th=float(o.ini_th_fast),
            min_th=float(o.min_th_fast), brief_mode=mode, device=device)

    imgs = [frames[i][0] for i in range(1, 1 + N_BINNED)]
    for mode in ("binned", "continuous"):
        extract(imgs[0], mode)                       # warm-up
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    binned, ms_b = [], []
    for img in imgs:
        t = time.perf_counter()
        binned.append(extract(img, "binned"))
        torch.cuda.synchronize()
        ms_b.append((time.perf_counter() - t) * 1e3)
    counts4 = dict(cuda_build.launch_counts)
    ms_c, kp_diff, same_desc = [], 0.0, []
    for img, fb in zip(imgs, binned):
        t = time.perf_counter()
        fc = extract(img, "continuous")
        torch.cuda.synchronize()
        ms_c.append((time.perf_counter() - t) * 1e3)
        kp_diff = max(kp_diff, float((fb.uv != fc.uv).any(1).float().mean()))
        v = fc.valid
        same_desc.append(float((fb.desc[v] == fc.desc[v]).all(1).float().mean()))
    log(f"binned extraction: {N_BINNED} frames, launches {counts4}; host ms/frame binned "
        f"{' '.join(f'{m:.2f}' for m in ms_b)} (median {statistics.median(ms_b):.2f}), "
        f"continuous {' '.join(f'{m:.2f}' for m in ms_c)} (median {statistics.median(ms_c):.2f}); "
        f"valid descriptors equal to the continuous mode's: "
        f"{' '.join(f'{x:.3f}' for x in same_desc)}")
    if counts4 != {"fast_and_blur": N_BINNED, "brief_continuous": 0, "brief_blocks": N_BINNED}:
        fail(f"binned extraction launch counts {counts4}; expected 1 K1 and 1 K3 per frame")
    if kp_diff != 0.0:
        fail("binned and continuous extraction chose different keypoints")

    # ---- phase 5: the local-mapping plane -----------------------------------
    del sysm, binned
    if phase5_mapping(cfg, frames[:N_DRIVE], traj, device, 0, tracking_only) < MIN_MAPPING_KEYFRAMES:
        phase5_mapping(cfg, frames[:N_DRIVE], traj, device, KF_EVERY, tracking_only)
    small_policy_drive(device, N_DRIVE)
    # tracking only once more, this late in the process: tells a slower
    # host (whatever the cause) from a cost of the mapping plane
    _, late = drive(cfg, frames[:N_LATE], device)
    late_ms = [ms for i, (r, ms) in enumerate(late) if i > 1 and not r.created_kf]
    log(f"tracking only again after the mapping drives, host ms/frame, fused, no keyframe: "
        f"{len(late_ms)} frames, median {statistics.median(late_ms):.2f}, all "
        f"{' '.join(f'{x:.1f}' for x in late_ms)}")

    # ---- phase 6: the loop-closing plane ------------------------------------
    del late
    loop_cfg = loop_closing_config()
    t0 = time.perf_counter()
    loop_traj, loop_frames = render_loop_drive(loop_cfg, device)
    torch.cuda.synchronize()
    log(f"rendered {N_LOOP} frames of the loop drive in {time.perf_counter() - t0:.1f} s")
    loop_run = phase6_loop(loop_cfg, loop_traj, loop_frames, device, 0)
    if loop_run is None:
        loop_run = phase6_loop(loop_cfg, loop_traj, loop_frames, device, KF_EVERY)
    if loop_run is None:
        fail("no loop was closed over the loop drive")
    loop_sys, sync_loop = loop_run
    # ---- phase 8, first half: a tree vocabulary trained on that map ----------
    vocab_path = phase8_vocabulary(loop_cfg, loop_sys, loop_traj, loop_frames, device)
    phase6_relocalization(loop_cfg, loop_sys, loop_frames, device)
    loop_sys.shutdown()
    del loop_sys
    log(f"command time so far: {time.perf_counter() - T_START:.1f} s")

    # ---- phase 7: the atlas weld ---------------------------------------------
    phase7(loop_cfg, traj, frames, device)
    log(f"command time so far: {time.perf_counter() - T_START:.1f} s")

    # ---- phase 10: the two other LiDAR upsamplers on the fused step ----------
    id_depth = prof_stats[0][3].get("track.depth", (0.0, 0.0, 0)) if prof_stats else (0.0, 0.0, 0)
    phase10_upsamplers(cfg, traj, frames, device, id_depth)
    del frames
    log(f"command time so far: {time.perf_counter() - T_START:.1f} s")

    # ---- phase 8, second half: the loop drive with vocab_path set ------------
    phase8_vocab_drive(loop_cfg, loop_traj, loop_frames, vocab_path, device)
    log(f"command time so far: {time.perf_counter() - T_START:.1f} s")

    # ---- phase 9: the asynchronous planes on phase 6's frames ----------------
    phase9_async(loop_cfg, loop_traj, loop_frames, device, sync_loop)
    del loop_frames
    log(f"command time: {time.perf_counter() - T_START:.1f} s")

    kernels = [
        {"name": "fast_and_blur", "route": "cuda",
         "source": "orb_slam3_rgbl_tpu_torch/csrc/frontend.cu",
         "replaces": "orb_slam3_rgbl_tpu/ops/frontend_pallas.py:124",
         "launches": counts["fast_and_blur"]},
        {"name": "brief_continuous", "route": "cuda",
         "source": "orb_slam3_rgbl_tpu_torch/csrc/brief.cu",
         "replaces": "orb_slam3_rgbl_tpu/ops/brief_pallas.py:425",
         "launches": counts["brief_continuous"]},
        {"name": "brief_blocks", "route": "cuda",
         "source": "orb_slam3_rgbl_tpu_torch/csrc/brief.cu",
         "replaces": "orb_slam3_rgbl_tpu/ops/brief_pallas.py:214",
         "launches": counts4["brief_blocks"]},
    ]
    for entry in kernels:
        m = k[entry["name"]]
        entry.update(max_abs_err=m["err"], ms=m["ms"], plain_ms=m["plain_ms"],
                     bound_ms=m["bound"][0], bound_by=m["bound"][1], library_ms=None)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    # the script drives one card, whatever else is visible
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
