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
closing on — over 132 frames (100 under the natural policy) of a circle of 6 m radius inside a closed
square room (one lap of 84 frames, then 48 frames over the start): every
keyframe is indexed in the keyframe database, a loop is detected, verified
by Sim3, corrected (fusion, essential graph, landmark re-anchoring) and
followed by a 16-iteration global BA. It checks the event's keyframes, every
frame's state, that the frames after the event stay on the fused step, the
binding invariants after the correction and after the global BA's
writeback, both solvers' costs, that a second global BA of the same snapshot
gives the same bits and launches G1 and G2 (``csrc/gba.cu``) once each a CG
step (``gba_cg_update`` once more a linearization), that none of the three
loop solvers waits for the card, the launch counts and the trajectory after
the loop; it holds G1 and G2 against their plain versions on that solve's
first linearization and times them (the ``kernels`` line's G entries), and
prints what every keyframe, candidate and event cost, the event split by
``loop.*`` span. Beside them, G3 (``gba_pair_hv``) and the 15-wide
``gba_cg_update`` and ``gba_cg_direction`` run one whole inertial solve at
the shapes of the benchmark's inertial cell (its map, made from ``SEED``)
and are held, timed and bounded the same way (``--gba-inertial`` runs that
block alone); so is G4, the visual solve's LM iteration outside CG
(``gba_linearize``, ``gba_pose_blocks``, ``gba_cost``, ``gba_apply_step``),
at the shapes of the benchmark's two visual cells (``--gba-lm`` alone).
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
frame, and drives the first 100 frames of phase 6's forced pass again with
``vocab_path`` set: it must close the loop.
Phase 9 drives phase 6's forced pass with ``async_mapping = True``; phase 10
drives phase 2's first 21 frames with the two other LiDAR upsamplers.
Phase 11 writes phase 2's 41 frames to disk as a KITTI odometry sequence
(8-bit RGB PNGs, 16-bit depth PNGs, ``.bin`` clouds, a flat-key settings
file) and runs the two KITTI drivers of ``orb_slam3_rgbl_tpu_torch/examples``
on it as users run them: RGB-L with ``--stats``, RGB-D with
``--save-atlas``, a fresh RGB-D driver with ``--load-atlas`` over frames
20–40 (relocalized on the first frame, then in localization mode), and 11
frames of a distorted camera (per-stage path). It checks every frame, the
launches, the decoded images bit for bit, the frozen map and the
trajectories, and prints the drivers' host ms per frame, the stage table,
decode ms per PNG and the atlas's save and load ms and bytes.

Phase 12 drives the stereo and monocular sensors over phase 2's canyon: the
41 frames as rectified pairs through ``System(cfg).track_stereo`` (the
camera of the reference's ``Examples/Stereo/KITTI00-02.yaml``, the right
image rendered at the baseline bf / fx; mapping and loop closing on), 11
pairs of a right camera turned by 0.5 degrees with both images distorted and
a ``Camera2`` settings file (the System rectifies them), the 41 frames
through ``track_monocular`` (two-view initialization, then the fused step
without depth), and the stereo KITTI driver on phase 11's sequence with
``image_0`` / ``image_1`` written beside it. It checks every frame's state,
2 K1 + 2 K2 launches a stereo frame and 1 + 1 a monocular one, the mapping
jobs' bindings, the rectified baseline, the monocular initialization frame
and the frames that take the fused step, no sync inside the monocular fused
step, the trajectories (Sim3-aligned for the monocular drive), and prints
host ms per kind of frame, the share of keypoints with a stereo depth
before and after the SAD refinement, the row matcher's device ms and
kernels and the peak memory.

Phase 13 drives the inertial sensors through ``run_euroc`` on a
EuRoC-shaped sequence it writes (752×480 distorted stereo at 20 fps, a
200 Hz IMU, the reference's EuRoC settings): stereo-inertial over 48
frames, then monocular-inertial over 160 (``--phase13 MODE`` runs one),
after K1 and K2 are held to their plain versions at that width.
The stereo drive ends ~1.2 s after its IMU initialization and its VIBA1
runs on the driven state (``LocalMapper.maybe_viba`` 5 s after the
initialization); the monocular drive reaches its VIBA1.
It checks every frame after the IMU initialization, the initialization's
frame, VIBA1, the launch counts, the three solvers under
``set_sync_debug_mode("error")``, the bindings after every job, and
gravity, ATE, speed and (monocular) scale against the ground truth; it
prints host ms per kind of frame and of each solve, and the card's busy
time (the union of its kernels' intervals) in three profiled solves.
``--phase13`` runs phase 13 alone.

Phase 14 drives the KannalaBrandt8 fisheye pair through ``run_euroc`` on a
TUM-VI-shaped sequence it writes: 512x512 fisheye stereo (the TUM-VI-like
calibration of ``tests/test_fisheye_e2e.py``, the right camera 0.101 m to
the side and turned by 0.5 degrees, unrectified) at 20 fps with a 200 Hz
IMU, rendered here by casting KB8 rays through a 5 m room, and a
``Camera.type: "KannalaBrandt8"`` settings file. K1 and K2 are held to their
plain versions at 512x512 first. ``--mode stereo`` drives 40 frames (mapping
and loop closing as the settings leave them), ``--mode stereo-inertial``
ends a few frames after its IMU initialization. It checks every frame, 2 K1
+ 2 K2 launches a frame, the bindings after every mapping job, the
off-axis landmarks' KB8 reprojection, ATE and the IMU initialization's frame,
and the KB8 pose solve, local BA and inertial solves under
``set_sync_debug_mode("error")``; it prints host ms per kind of frame,
``attach_stereo_fisheye_depth``'s host ms, device ms and kernels, the share
of valid left keypoints with a fisheye depth and the peak memory.
``--phase14`` runs phase 14 alone.

Phase 15 drives the users' host-side surface on phase 2's canyon written as
a KITTI sequence (41 frames, RGB PNGs through all five row filters,
131,072-point clouds): (a) ``io/native_loader.NativeKittiSequence`` against
``KittiSequence`` on every frame, then the RGB-L driver, which loads
through it (the PNGs decoded ahead in worker processes); (b) ``tools/kitti_publisher.publish`` into an
``io/online.OnlineSlamNode`` at full speed into a queue that holds every
frame, then at KITTI's 10 Hz into the default queue of 4 with the
asynchronous planes; (c) ``tools/project_velodyne`` (then the RGB-D driver
on its depth PNGs), ``tools/train_vocabulary`` and ``tools/evaluate_ate``.
It checks every frame, the launches (and that the node's worker thread,
tracking on a stream other than the default, launches K1 and K2 there and
an asynchronous System takes that stream for tracking), the frames bit for
bit, the node's poses against the driver's, that no loader worker
outlives ``close()``, the tools' files against the same computation in
process; it prints the driver loop's wall, tracking and load-wait ms per
frame beside ``KittiSequence``'s in-process decode, the node's drops,
latency and states, and each tool's ms. ``--phase15`` runs phase 15 alone.

Phase 16 drives the landmark-sharded global BA (``parallel/sharded_ba``):
(a) ``__graft_entry__.dryrun_multichip``'s problem (K=256 poses, M=65,536
landmarks seen 4 times, ``synthetic.synth_gba_problem``; 6 LM iterations ×
260 CG steps) through ``make_distributed_pcg_ba`` over NCCL at world 1 in
this process (under ``set_sync_debug_mode("error")``, then under the
profiler) and over gloo at world 2 with both ranks' tensors on this card
(NCCL refuses two ranks on one card), each held to ``__graft_entry__``'s
bars against ``global_bundle_adjust`` with the replicated poses bit-equal
on every rank and in two solves, the single-device and the world-1 solve
each launching G1 and G2 as phase 6's does; (b) the dense-Schur oracle (K 6, M 320)
at worlds 1 and 2; (c) ``tools/bench_scaling`` at ranks 1 and 2. It prints
host ms a solve, kernels and device busy ms at world 1, collectives and
bytes per LM iteration and the peak memory. ``--phase16`` runs it alone.

Phase 17 drives the viewer and the map probes on phase 2's canyon: (a) 21
frames through ``track_rgbl`` without and then with ``start_viewer(hz=2.0,
http_port=0)`` (renders counted and timed, both PNGs decoded, the HTTP
index and a PNG fetched, ``shutdown()`` stops the thread; 1 K1 + 1 K2 a
frame); (c) the frames with the mapping plane on, the map saved with its
ground truth, then ``tools/gba_probe`` (the keyframe ATE may rise by less
than ``MAX_PROBE_ATE_RISE_M``, bindings consistent) and
``tools/map_stage_probe``; (b) the RGB-L driver with ``--viz`` on 11 of
the frames written as a KITTI sequence. ``--phase17`` runs it alone.

Without arguments the script runs phases 1-5 and then phases 6-17 in
five processes of their own, started fresh side by side on the same card
(``--loop-phases``: 6, 8 and 9; ``--canyon-phases``: 7, 10, 11 and 12;
``--phase13 stereo-inertial --phase14 --phase15``; ``--phase13 mono-inertial``;
``--phase16 --phase17``), each with its share of the host's cores. Every phase is bound by its
host's launch rate, with the card idle most of the time, and a process
slows down as it ages, so the script ends well inside its time limit;
phases 1-5 (the kernels' times, the main path's latency) have the host
and the card to themselves, the others share them (any group alone, by
its flags, has them to itself). Their output is relayed at the end; the
script fails as soon as one fails, and kills the others.

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
import atexit
import ctypes
import dataclasses
import json
import os
import pathlib
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam3_rgbl_tpu_torch import cuda_build
from orb_slam3_rgbl_tpu_torch import synthetic as syn
from orb_slam3_rgbl_tpu_torch.config import MONOCULAR, STEREO, kitti_rgbl_config
from orb_slam3_rgbl_tpu_torch.device import synchronize as _synchronize
from orb_slam3_rgbl_tpu_torch.geometry import align, lie
from orb_slam3_rgbl_tpu_torch.io.png import write_png
from orb_slam3_rgbl_tpu_torch.ops import brief_cuda, depth as depth_ops, fast as fast_ops
from orb_slam3_rgbl_tpu_torch.ops import frontend_cuda, gba_cuda
from orb_slam3_rgbl_tpu_torch.ops.matching import stereo_row_match
from orb_slam3_rgbl_tpu_torch.ops import orb as orb_ops, pyramid as pyr_ops
from orb_slam3_rgbl_tpu_torch.optim import global_ba, local_ba, pose_graph
from orb_slam3_rgbl_tpu_torch.optim import sim3 as sim3_opt
from orb_slam3_rgbl_tpu_torch.retrieval.keyframe_db import KeyFrameDatabase
from orb_slam3_rgbl_tpu_torch.retrieval.tree_vocab import train_vocabulary
from orb_slam3_rgbl_tpu_torch.slam import frame as frame_mod, tracking as trk
from orb_slam3_rgbl_tpu_torch.slam import map_state as map_mod, merging
from orb_slam3_rgbl_tpu_torch.slam.compiled import extract as compiled_extract, lidar_projection
from orb_slam3_rgbl_tpu_torch.slam.local_mapping import MAP_SPANS, LocalMapper
from orb_slam3_rgbl_tpu_torch.slam.fast_path import FastPath
from orb_slam3_rgbl_tpu_torch.slam.loop_closing import GBA_CG_ITERS, GBA_CHUNK, LOOP_SPANS, LoopCloser
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
# frames of the two loop drives that need not see the whole drive: the
# natural-policy pass of phase 6 (no loop event at this width in any run
# since PR 5) and phase 8's vocab_path drive (its loop closed at frame 76)
N_LOOP_SHORT = 100
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
GBA_REL_TOL = 1e-5      # G1 and G2's block apply vs their plain versions, of the largest value
                        # (tests/test_torch_gpu.py's bar); the fused updates are bit-equal
GBA_VI_CELL = "euroc_mh_stereo_inertial_map.viba_one_call"   # G3's shapes: the benchmark's cell
GBA_LM_CELLS = ("kitti00_rgbl_map.gba_one_call", "euroc_mh_stereo_map.gba_one_call")   # G4's

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


def _profile(cpu: bool = True):
    act = [torch.profiler.ProfilerActivity.CUDA] + (
        [torch.profiler.ProfilerActivity.CPU] if cpu else [])
    return torch.profiler.profile(activities=act)


def _device_work(events) -> list:
    """The card's own work among profiler events (kernels, copies, sets),
    without the device-side ranges of ``record_function`` spans, which
    cover the work inside them."""
    return [e for e in events if _on_device(e) and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("track.", "map.", "loop.", "merge.", "gba."))]


def _busy_ms(events) -> float:
    """The union of the events' intervals (ms): the time the card was busy."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if hi is None or a > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (total + (0.0 if hi is None else hi - lo)) / 1e3


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


def phase1_kernels(cfg, device, device_times: bool = True, image=None) -> dict:
    """K1, K2 and K3 against their plain versions at the main path's shapes,
    on ``image`` (by default a rendered frame of the canyon); without
    ``device_times``, event times only (no profiler trace: late in this
    process the profiler stops recording K1's device time)."""
    dev_ms = kernel_device_ms if device_times else (lambda fn, name, iters=20: float("nan"))
    cam, o = cfg.camera, cfg.orb
    if image is None:
        image = render_drive(cfg, 1, device, n_az=64, n_el=8)[1][0][0]
    levels = [lv.contiguous() for lv in pyr_ops.build_pyramid(
        image, cam.height, cam.width, o.n_levels, o.scale_factor)]
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
    dms1 = dev_ms(k1_all, "fast_blur_kernel")
    dms1_each = dev_ms(k1_each, "fast_blur_kernel")
    dms1_call = dev_ms(k1_all, "")
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
    dms2 = dev_ms(k2, "brief_kernel")
    dms2_call = dev_ms(k2, "")
    log(f"K2 {N} keypoints on a {Hc}x{Wc} composite: bit-identical to the plain version "
        f"(tables, then gather) and to orb.brief_descriptors ({int(inside.sum())} in-patch "
        f"keypoints), all {idx.numel()} rotated positions equal to continuous_index_tables; "
        f"{ms2:.4f} ms by events, kernel alone {dms2:.4f} ms on the device ({dms2_call:.4f} ms "
        f"with cos and sin); plain {pms2:.4f} ms, gather form {gms2:.4f} ms")

    # the floor of a launch: an empty kernel at K1's and at K2's grid
    grids = {"K1": (k1_blocks, frontend_cuda.THREADS),
             "K2": (-(-N // brief_cuda.K2_KPB), 256)}
    for name, (blocks, threads) in grids.items() if device_times else ():
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
    dms3 = dev_ms(k3, "brief_binned_kernel")
    log(f"K3 {S} slots ({N} keypoints, {block_bins.shape[0]} blocks) on the same composite: "
        f"bit-identical to brief_blocks_plain on all {S} slots and to brief_binned_plain on "
        f"{int(inside.sum())} keypoints; kernel {ms3:.4f} ms (device time alone {dms3:.4f} ms), "
        f"plain {pms3:.4f} ms, gather form {gms3:.4f} ms")
    if device_times:
        floor_dev, floor_evt = empty_launch_ms(-(-S // brief_cuda.K3_KPB), 256)
        log(f"empty kernel at K3's grid ({-(-S // brief_cuda.K3_KPB)} x 256): {floor_dev:.4f} ms "
            f"on the device, {floor_evt:.4f} ms by events")

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

    def timed_apply(self, event, **kw):
        rec["kf_err"]["before"] = kf_centre_errors(self.map, traj)
        _synchronize(device)
        t = time.perf_counter()
        orig_apply(self, event, **kw)
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


def check_gba_launches(what: str, counts: dict, iterations: int, cg_iters: int, device,
                       calls: int = 1, visual: bool = True):
    """The solve's kernel launches over ``calls`` calls of ``iterations`` LM
    iterations × ``cg_iters`` CG steps in all: one ``gba_hv``,
    ``gba_pose_sum``, ``gba_cg_update`` and ``gba_cg_direction`` a step, and
    one more ``gba_cg_update`` a linearization (the PCG set-up's apply); in
    the visual solve (G4) one ``gba_linearize``, ``gba_pose_blocks`` and
    ``gba_apply_step`` an LM iteration and one ``gba_cost`` (the cost pass)
    an iteration and a call (its final pass); none on the CPU, where the
    plain versions run."""
    on_card = device.type == "cuda"
    steps = iterations * cg_iters if on_card else 0
    lm = iterations if on_card and visual else 0
    final = calls if on_card and visual else 0
    expect = {"gba_hv": steps, "gba_pose_sum": steps,
              "gba_cg_update": steps + (iterations if on_card else 0), "gba_cg_direction": steps,
              "gba_linearize": lm, "gba_pose_blocks": lm, "gba_apply_step": lm,
              "gba_cost": lm + final}
    got = {k: counts[k] for k in expect}
    if got != expect:
        fail(f"{what}: solve launches {got}, expected {expect}")


@contextlib.contextmanager
def kept_gba_operators():
    """Keeps the first ``gba_cuda.HessianProduct``, ``BlockJacobi`` and
    ``PairProduct`` that a solve makes (its first linearization's), under
    "hv", "precond" and "pair_hv"."""
    made = {}
    classes = {"hv": gba_cuda.HessianProduct, "precond": gba_cuda.BlockJacobi,
               "pair_hv": gba_cuda.PairProduct}
    inits = {key: cls.__init__ for key, cls in classes.items()}

    def keeping(key):
        def init(self, *a, **k):
            inits[key](self, *a, **k)
            made.setdefault(key, self)
        return init

    for key, cls in classes.items():
        cls.__init__ = keeping(key)
    try:
        yield made
    finally:
        for key, cls in classes.items():
            cls.__init__ = inits[key]


def gba_kernels(made: dict, counts: dict, device) -> list:
    """G1 (``gba_hv`` + ``gba_pose_sum``) and G2 (``gba_cg_update``,
    ``gba_cg_direction``) on a solve's first linearization (``made``, from
    ``kept_gba_operators``): each wrapper against its plain version on
    random vectors of the solve's shapes (``GBA_REL_TOL`` for H·v and the
    block apply, bit for bit for the fused updates), two calls the same
    bits; event ms of the wrapper's call, device ms of the kernel, the plain
    version's event ms and the bound by bytes. Returns the ``kernels``
    entries, with the solve's ``counts``; none on the CPU."""
    if device.type != "cuda":
        log("CG-step kernels: the CPU runs their plain versions; nothing to compare")
        return []
    hv, bj = made["hv"], made["precond"]
    Jp, Jl, w, obs_kf, seg, lam_l, lm_free = hv.args
    Minv_p, Minv_l, pose_free, _ = bj.args
    M, D = obs_kf.shape
    K, L = seg.table.shape
    g = torch.Generator().manual_seed(0)

    def pair():
        return (torch.randn(K, 6, generator=g).to(device), torch.randn(M, 3, generator=g).to(device))

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    v = pair()
    got, again = hv(*v), hv(*v)
    want = gba_cuda.hv_plain(Jp, Jl, w, obs_kf, seg, *v, lam_l, lm_free)
    dot_err = abs(float(got[2]) - float(want[2]))
    dot_scale = float((v[1] * want[1]).abs().sum())
    rel_p, rel_l = rel(got[0], want[0]), rel(got[1], want[1])
    if not same(got, again):
        fail("G1: two H·v calls on the same vectors differ")
    if not (rel_p <= GBA_REL_TOL and rel_l <= GBA_REL_TOL and dot_err <= GBA_REL_TOL * dot_scale):
        fail(f"G1 against hv_plain: pose half {rel_p:.3g}, landmark half {rel_l:.3g} of the largest "
             f"value, dot share {dot_err:.3g} of {dot_scale:.3g} (limit {GBA_REL_TOL})")

    def plain_precond(a, b):
        return gba_cuda.precond_plain(Minv_p, Minv_l, a, b, pose_free, lm_free)

    z, z_want = bj(*v), plain_precond(*v)
    rel_z = max(rel(a, b) for a, b in zip(z, z_want))
    if not same(z, bj(*v)) or not rel_z <= GBA_REL_TOL:
        fail(f"G2's block apply against precond_plain: {rel_z:.3g} of the largest value "
             f"(limit {GBA_REL_TOL}), or two calls differ")
    rz, pAp, rz_new = (torch.rand((), generator=g).to(device) + 0.5 for _ in range(3))
    x, rr, p, Ap = pair(), pair(), pair(), pair()
    upd = bj.update(rz, pAp, x, rr, p, Ap)
    upd_want = gba_cuda.cg_update_plain(bj, rz, pAp, x, rr, p, Ap)
    d = gba_cuda.cg_direction(rz_new, rz, upd[2], p)
    d_want = gba_cuda.cg_direction_plain(rz_new, rz, upd[2], p)
    if not (all(same(a, b) for a, b in zip(upd, upd_want)) and same(d, d_want)):
        fail("G2: the fused CG updates differ from the separate PyTorch operations' bits")
    torch.cuda.synchronize()

    n_live = int((w != 0).sum())
    n_held = int((seg.table < seg.n_obs).sum())
    # least bytes: the live slots' Jacobians, keyframe index and pose
    # partial, every slot's weight, the landmarks' vectors, damping, mask and
    # result; the pose table, the weight of each entry, the live partials;
    # the blocks, masks and the step's vectors
    nbytes = {"gba_hv": n_live * (72 + 36 + 8 + 24) + M * D * 4 + M * (12 + 12 + 1 + 12) + K * 24,
              "gba_pose_sum": K * L * 8 + n_held * 4 + n_live * 24 + K * 24,
              "gba_cg_update": K * (144 + 1 + 7 * 24) + M * (36 + 1 + 7 * 12),
              "gba_cg_direction": 3 * (K * 24 + M * 12)}
    # f32 instructions: Jv, u, Jpᵀu and Jlᵀu a live slot, D partials and the
    # damping a landmark; 6 adds a live entry; the updates and the block
    # products; a multiply and an add a value
    nops = {"gba_hv": n_live * (27 + 3 + 18 + 9) + M * (3 * D + 9),
            "gba_pose_sum": n_live * 6 + K * L,
            "gba_cg_update": K * (24 + 36) + M * (12 + 9),
            "gba_cg_direction": 2 * (6 * K + 3 * M)}
    calls = {"gba_hv": lambda: hv(*v), "gba_pose_sum": lambda: hv(*v),
             "gba_cg_update": lambda: bj.update(rz, pAp, x, rr, p, Ap),
             "gba_cg_direction": lambda: gba_cuda.cg_direction(rz_new, rz, z, p)}
    plains = {"gba_hv": lambda: gba_cuda.hv_plain(Jp, Jl, w, obs_kf, seg, *v, lam_l, lm_free),
              "gba_cg_update": lambda: gba_cuda.cg_update_plain(plain_precond, rz, pAp, x, rr, p, Ap),
              "gba_cg_direction": lambda: gba_cuda.cg_direction_plain(rz_new, rz, z, p)}
    plains["gba_pose_sum"] = plains["gba_hv"]
    errs = {"gba_hv": float((got[1] - want[1]).abs().max()),
            "gba_pose_sum": max(float((got[0] - want[0]).abs().max()), dot_err),
            "gba_cg_update": max(float((a - b).abs().max()) for a, b in zip(z, z_want)),
            "gba_cg_direction": 0.0}
    entries = []
    for name, call in calls.items():
        t, by = bound(nbytes[name], nops[name])
        entries.append({"name": name, "route": "cuda",
                        "source": "orb_slam3_rgbl_tpu_torch/csrc/gba.cu", "replaces": None,
                        "launches": counts[name], "max_abs_err": errs[name], "ms": time_cuda(call),
                        "device_ms": kernel_device_ms(call, name + "_kernel"),
                        "plain_ms": time_cuda(plains[name]), "bound_ms": t, "bound_by": by,
                        "library_ms": None})
    setup_ms = kernel_device_ms(lambda: bj(*v), "gba_cg_update_kernel")
    log(f"CG-step kernels on the solve's first linearization (K {K}, M {M}, D {D}, {n_live} live "
        f"of {M * D} slots, pose table width {L}): H·v against hv_plain, pose half {rel_p:.3g}, "
        f"landmark half {rel_l:.3g} of the largest value, dot share {dot_err:.3g} of "
        f"{dot_scale:.3g}; block apply {rel_z:.3g}; fused updates and direction bit-equal to "
        f"the separate operations; two calls the same bits; the apply alone "
        f"{setup_ms:.4f} ms on the device (timed beside the other phases' processes)")
    for e in entries:
        log(f"  {e['name']}: {e['launches']} launches in the solve; event ms {e['ms']:.4f} (the "
            f"wrapper's call), device ms {e['device_ms']:.4f}, plain {e['plain_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']}, max |err| {e['max_abs_err']:.3g}")
    return entries


def gba_inertial_kernels(device) -> list:
    """G3 (``gba_pair_hv``) and the 15-wide ``gba_cg_update`` and
    ``gba_cg_direction`` at the shapes of the benchmark's inertial cell
    (``GBA_VI_CELL``: 199 states, 198 pairs, 29,850 landmarks, 8 slots a
    landmark): one whole solve of the cell's schedule on its map counts the
    launches and keeps the operators of its first linearization
    (``kept_gba_operators``); then each wrapper against its plain version on
    random vectors of those shapes — the pair product and the fused updates
    bit for bit (their plain versions add in the kernels' order), the 15×15
    block apply to ``GBA_REL_TOL`` of the largest value — and two calls the
    same bits; event ms of the wrapper's call, device ms of the kernel, the
    plain version's event ms, the bound by bytes and an empty kernel's floor
    at the kernel's grid. Returns the ``kernels`` entries; none on the CPU."""
    if device.type != "cuda":
        log("inertial CG-step kernels: the CPU runs their plain versions; nothing to compare")
        return []
    from slambench import run as bench      # the benchmark's map of the inertial cell
    root = pathlib.Path(__file__).resolve().parent
    cell, config = bench.load_cell(root, GBA_VI_CELL)
    problem = bench.load_problem(root, config)
    solver = problem.Solver(config, cell, problem.make_map(config, cell, SEED), device)
    solver.warm()
    sched = cell["schedule"]
    with kept_gba_operators() as made:
        cuda_build.reset_launch_counts()
        solver.solve([])
    counts = dict(cuda_build.launch_counts)
    check_gba_launches("the inertial cell's solve", counts, sched["lm_iterations"],
                       sched["cg_steps"], device, visual=False)
    steps = sched["lm_iterations"] * sched["cg_steps"]
    if counts["gba_pair_hv"] != steps:
        fail(f"the inertial cell's solve: {counts['gba_pair_hv']} gba_pair_hv launches, "
             f"expected one a CG step ({steps})")
    hv, bj, ph = made["hv"], made["precond"], made["pair_hv"]
    J, w, pair_i, pair_j, table, lam, state_free = ph.args
    Minv_s, Minv_l, _, lm_free = bj.args
    K, M, P, Lp = Minv_s.shape[0], Minv_l.shape[0], J.shape[0], table.shape[1]
    g = torch.Generator().manual_seed(0)

    def pair():
        return (torch.randn(K, 15, generator=g).to(device),
                torch.randn(M, 3, generator=g).to(device))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def plain_precond(a, b):
        return gba_cuda.precond_plain(Minv_s, Minv_l, a, b, state_free, lm_free)

    v = pair()
    Hp, _, lm_half = hv(*v)
    got, again = ph(Hp, v[0], lm_half), ph(Hp, v[0], lm_half)
    want = gba_cuda.pair_hv_plain(Hp, J, w, pair_i, pair_j, table, v[0], lam, state_free, lm_half)
    pair_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not same(got, again):
        fail("G3: two gba_pair_hv calls on the same vectors differ")
    if not same(got, want):
        fail(f"G3 against pair_hv_plain: not the same bits (max |err| {pair_err:.3g})")
    z, z_want = bj(*v), plain_precond(*v)
    rel_z = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(z, z_want))
    if not same(z, bj(*v)) or not rel_z <= GBA_REL_TOL:
        fail(f"the 15-wide block apply against precond_plain: {rel_z:.3g} of the largest value "
             f"(limit {GBA_REL_TOL}), or two calls differ")
    rz, pAp, rz_new = (torch.rand((), generator=g).to(device) + 0.5 for _ in range(3))
    x, rr, p, Ap = pair(), pair(), pair(), pair()
    upd = bj.update(rz, pAp, x, rr, p, Ap)
    upd_want = gba_cuda.cg_update_plain(bj, rz, pAp, x, rr, p, Ap)
    d = gba_cuda.cg_direction(rz_new, rz, upd[2], p)
    d_want = gba_cuda.cg_direction_plain(rz_new, rz, upd[2], p)
    if not (all(same(a, b) for a, b in zip(upd, upd_want)) and same(d, d_want)):
        fail("the 15-wide fused CG updates differ from the separate PyTorch operations' bits")
    torch.cuda.synchronize()

    # least bytes: each pair's Jacobian, weights and endpoints, each state's
    # visual pose sum, vector, damping, mask, table row and result, the dot;
    # the 15×15 and 3×3 blocks, masks and the step's seven vectors; three
    # vectors. f32 instructions: J·[v_i; v_j], its weighting and Jᵀ·u a pair,
    # each output's table entries, damping, mask and dot; the updates and the
    # block products; a multiply and an add a value
    nbytes = {"gba_pair_hv": P * (465 * 4 + 16) + K * (51 * 4 + 1 + Lp * 8) + 8,
              "gba_cg_update<15>": K * (900 + 1 + 7 * 60) + M * (36 + 1 + 7 * 12),
              "gba_cg_direction<15>": 3 * (K * 60 + M * 12)}
    nops = {"gba_pair_hv": P * (450 + 15 + 450) + K * 15 * (Lp + 3),
            "gba_cg_update<15>": K * (60 + 225) + M * (12 + 9),
            "gba_cg_direction<15>": 2 * (15 * K + 3 * M)}
    calls = {"gba_pair_hv": lambda: ph(Hp, v[0], lm_half),
             "gba_cg_update<15>": lambda: bj.update(rz, pAp, x, rr, p, Ap),
             "gba_cg_direction<15>": lambda: gba_cuda.cg_direction(rz_new, rz, z, p)}
    plains = {"gba_pair_hv": lambda: gba_cuda.pair_hv_plain(Hp, J, w, pair_i, pair_j, table, v[0],
                                                            lam, state_free, lm_half),
              "gba_cg_update<15>": lambda: gba_cuda.cg_update_plain(plain_precond, rz, pAp, x,
                                                                    rr, p, Ap),
              "gba_cg_direction<15>": lambda: gba_cuda.cg_direction_plain(rz_new, rz, z, p)}
    errs = {"gba_pair_hv": pair_err,
            "gba_cg_update<15>": max(float((a - b).abs().max()) for a, b in zip(z, z_want)),
            "gba_cg_direction<15>": 0.0}
    launches = {"gba_pair_hv": counts["gba_pair_hv"], "gba_cg_update<15>": counts["gba_cg_update"],
                "gba_cg_direction<15>": counts["gba_cg_direction"]}
    grids = {"gba_pair_hv": (1, gba_cuda.PAIR_THREADS),
             "gba_cg_update<15>": (-(-(K + M) // gba_cuda.THREADS), gba_cuda.THREADS),
             "gba_cg_direction<15>": (-(-(15 * K + 3 * M) // gba_cuda.THREADS), gba_cuda.THREADS)}
    entries = []
    for name, call in calls.items():
        t, by = bound(nbytes[name], nops[name])
        kernel = name.replace("<", "_kernel<") if "<" in name else name + "_kernel"
        floor = empty_launch_ms(*grids[name])
        entries.append({"name": name, "route": "cuda",
                        "source": "orb_slam3_rgbl_tpu_torch/csrc/gba.cu", "replaces": None,
                        "launches": launches[name], "max_abs_err": errs[name],
                        "ms": time_cuda(call), "device_ms": kernel_device_ms(call, kernel),
                        "plain_ms": time_cuda(plains[name]), "bound_ms": t, "bound_by": by,
                        "floor_ms": floor, "library_ms": None})
    log(f"inertial CG-step kernels on the solve's first linearization (K {K}, P {P}, M {M}, "
        f"pair table width {Lp}): gba_pair_hv bit-equal to pair_hv_plain; 15-wide block apply "
        f"{rel_z:.3g} of the largest value; fused updates and direction bit-equal to the "
        f"separate operations; two calls the same bits")
    for e in entries:
        log(f"  {e['name']}: {e['launches']} launches in the solve; event ms {e['ms']:.4f}, "
            f"device ms {e['device_ms']:.4f}, plain {e['plain_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.6f} ms by {e['bound_by']}, floor {e['floor_ms'][0]:.4f} / "
            f"{e['floor_ms'][1]:.4f} ms (device / event), max |err| {e['max_abs_err']:.3g}")
    return entries


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
    with kept_gba_operators() as made:
        cuda_build.reset_launch_counts()
        out2, enq, ms = timed_without_sync(lambda: closer._gba_iterate(snapshot, iterations),
                                           device)
    gba_counts = dict(cuda_build.launch_counts)
    check_gba_launches("the loop event's global BA", gba_counts, iterations, GBA_CG_ITERS, device,
                       calls=-(-iterations // GBA_CHUNK))
    res1, res2 = out[2], out2[2]
    same = (torch.equal(res1.poses, res2.poses) and torch.equal(res1.landmarks, res2.landmarks)
            and torch.equal(res1.cost, res2.cost))
    log(f"global BA again on the same snapshot ({iterations} iterations x {GBA_CG_ITERS} CG steps): "
        f"enqueued in {enq:.1f} ms, done in {ms:.1f} ms, without a synchronizing call; bit-equal "
        f"to the first solve: {same}; CG-step launches "
        f"{ {k: v for k, v in gba_counts.items() if k.startswith('gba_')} }")
    if not same:
        fail("a second global BA of the same snapshot is not bit-equal to the first")
    print(json.dumps({"gba_kernels": gba_kernels(made, gba_counts, device)
                      + gba_inertial_kernels(device) + gba_lm_kernels(device)}),
          flush=True)
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


def gba_lm_kernels(device) -> list:
    """G4, the visual solve's LM iteration outside CG: the linearization
    (``gba_linearize`` + ``gba_pose_blocks``), the cost pass
    (``gba_linearize`` without Jacobians + ``gba_pose_blocks``' sum, counted
    as ``gba_cost``) and ``gba_apply_step`` at the shapes of the benchmark's
    two visual cells (``GBA_LM_CELLS``: their maps, made from ``SEED``,
    assembled as the cells assemble them): each against its plain version
    (``GBA_REL_TOL`` of the largest value; the active count, the final pass's
    active mask and the landmarks' update exactly; the final pass's chi² where
    active), two calls the same bits, the accept test's cost the
    linearization's to the bit; launches in one solve of the cell (its
    schedule), device ms of each pass's own kernels, and the wrapper's and
    the plain version's event ms (the pose pass has none of its own: it runs
    inside the linearization's call) against the bound by bytes. Returns the
    ``kernels`` entries; none on the CPU."""
    if device.type != "cuda":
        log("LM-iteration kernels: the CPU runs their plain versions; nothing to compare")
        return []
    from slambench import run as bench      # the benchmark's maps of the visual cells
    root = pathlib.Path(__file__).resolve().parent
    entries = []
    for cell_name in GBA_LM_CELLS:
        cell, config = bench.load_cell(root, cell_name)
        problem_mod = bench.load_problem(root, config)
        solver = problem_mod.Solver(config, cell, problem_mod.make_map(config, cell, SEED), device)
        sched = cell["schedule"]
        solver.warm()
        cuda_build.reset_launch_counts()
        solver.solve([])
        counts = dict(cuda_build.launch_counts)
        check_gba_launches(f"{cell_name}'s solve", counts, sched["lm_iterations"],
                           sched["cg_steps"], device,
                           calls=-(-sched["lm_iterations"] // sched["chunk"]))
        prob, seg = solver._assemble()
        cam, huber = solver.cam, sched["huber_iterations"] > 0
        lm_free = prob.lm_valid[:, None]
        K, (M, D) = prob.poses.shape[0], prob.obs_kf.shape
        L = seg.table.shape[1]

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

        got = global_ba.linearize(prob, cam, seg, huber, lm_free)
        again = global_ba.linearize(prob, cam, seg, huber, lm_free)
        total, n_active = global_ba.lm_cost(prob, cam, huber)
        final = global_ba.lm_cost(prob, cam, False, per_slot=True)
        want = global_ba.linearize_plain(prob, cam, seg, huber, lm_free)
        want_final = global_ba.cost_plain(prob, cam, False, per_slot=True)
        live = want.w != 0
        errs = {f: rel(getattr(got, f)[live], getattr(want, f)[live]) for f in ("Jp", "Jl")}
        errs.update({f: rel(getattr(got, f), getattr(want, f))
                     for f in ("w", "g_p", "Hpp_diag", "g_l", "Hll_diag", "cost")})
        errs["accept_cost"] = rel(total, global_ba.cost_plain(prob, cam, huber)[0])
        errs["final_cost"] = rel(final[0], want_final[0])
        errs["final_chi2"] = rel(final[2][want_final[3]], want_final[2][want_final[3]])
        if not (torch.equal(got.w != 0, live) and torch.equal(got.n_active, want.n_active)):
            fail(f"G4 at {cell_name}'s shapes: the live slots or the active count differ from "
                 f"linearize_plain's ({int(got.n_active)} against {int(want.n_active)})")
        if not (torch.equal(final[3], want_final[3]) and torch.equal(final[1], want_final[1])):
            fail(f"G4 at {cell_name}'s shapes: the final pass's active mask or count differs from "
                 f"cost_plain's ({int(final[1])} against {int(want_final[1])})")
        if max(errs.values()) > GBA_REL_TOL:
            fail(f"G4 against the plain versions at {cell_name}'s shapes: {errs} of the largest "
                 f"value (limit {GBA_REL_TOL})")
        if not all(torch.equal(getattr(got, f), getattr(again, f))
                   for f in ("w", "g_p", "Hpp_diag", "g_l", "Hll_diag", "cost", "n_active")):
            fail(f"G4 at {cell_name}'s shapes: two linearizations of one problem differ")
        if not (torch.equal(total, got.cost) and torch.equal(n_active, got.n_active)):
            fail(f"G4 at {cell_name}'s shapes: the accept test's cost {float(total)!r} is not the "
                 f"linearization's {float(got.cost)!r} to the bit")
        g = torch.Generator().manual_seed(0)
        dp = (torch.randn(K, 6, generator=g) * 1e-3).to(device)
        dl = (torch.randn(M, 3, generator=g) * 1e-2).to(device)
        step, step_want = (gba_cuda.apply_step(dp, prob.poses, dl, prob.landmarks),
                           gba_cuda.apply_step_plain(dp, prob.poses, dl, prob.landmarks))
        errs["apply_step"] = rel(step[0], step_want[0])
        if errs["apply_step"] > GBA_REL_TOL or not torch.equal(step[1], step_want[1]):
            fail(f"G4's step at {cell_name}'s shapes: poses {errs['apply_step']:.3g} of the "
                 f"largest value, or the landmarks not bit-equal")
        torch.cuda.synchronize()

        n_live = int(live.sum())
        considered = prob.obs_mask & prob.lm_valid[:, None] & prob.pose_valid[prob.obs_kf]
        n_cons = int(considered.sum())
        n_held = int((seg.table < seg.n_obs).sum())
        nb = -(-M // gba_cuda.landmarks_per_block(D))
        # least bytes: every slot's mask and weight; a considered slot's
        # keyframe index, uv, uR and 1/σ²; a live slot's Jp, Jl and w·r
        # written; each landmark's point, flags, g_l and Hll; the poses; the
        # partials. The pose pass: the table, the weight of each entry, a
        # live slot's Jp and w·r, each pose's 42 outputs. The cost: the
        # inputs of the first pass. The step: dp, T and the new pose, X, dl
        # and the new landmark
        slot_in = M * D * 1 + n_cons * 24 + M * 14 + K * 29
        nbytes = {"gba_linearize": slot_in + M * D * 4 + n_live * 120 + M * 48 + nb * 8,
                  "gba_pose_blocks": K * L * 8 + n_held * 4 + n_live * 84 + K * 168 + nb * 8,
                  "gba_cost": slot_in + nb * 8,
                  "gba_apply_step": K * (24 + 28 + 28) + M * 36}
        # f32 instructions: ~45 to fit a considered slot, ~130 for a live
        # slot's Jacobians and landmark partials; ~160 a live entry of the pose
        # pass; ~150 a pose of the step, one add a landmark value
        nops = {"gba_linearize": n_cons * 45 + n_live * 130 + M * 9 * D,
                "gba_pose_blocks": n_live * 160 + K * L,
                "gba_cost": n_cons * 45, "gba_apply_step": K * 150 + 3 * M}
        def lin_call():
            return global_ba.linearize(prob, cam, seg, huber, lm_free)

        # (the wrapper's call, the kernels that are the pass's own there, its plain version)
        passes = {
            "gba_linearize": (lin_call, "gba_linearize_kernel",
                              lambda: global_ba.linearize_plain(prob, cam, seg, huber, lm_free)),
            "gba_pose_blocks": (None, "gba_pose_blocks_kernel", None),
            "gba_cost": (lambda: global_ba.lm_cost(prob, cam, huber), "",
                         lambda: global_ba.cost_plain(prob, cam, huber)),
            "gba_apply_step": (lambda: gba_cuda.apply_step(dp, prob.poses, dl, prob.landmarks),
                               "gba_apply_step_kernel",
                               lambda: gba_cuda.apply_step_plain(dp, prob.poses, dl,
                                                                 prob.landmarks))}
        kernel_errs = {"gba_linearize": max(errs[f] for f in ("Jp", "Jl", "w", "g_l", "Hll_diag")),
                       "gba_pose_blocks": max(errs[f] for f in ("g_p", "Hpp_diag", "cost")),
                       "gba_cost": max(errs[f] for f in ("accept_cost", "final_cost",
                                                         "final_chi2")),
                       "gba_apply_step": errs["apply_step"]}
        for name, (call, kernel, plain) in passes.items():
            t, by = bound(nbytes[name], nops[name])
            entries.append({"name": name, "cell": cell_name, "route": "cuda",
                            "source": "orb_slam3_rgbl_tpu_torch/csrc/gba.cu", "replaces": None,
                            "launches": counts[name], "max_rel_err": kernel_errs[name],
                            "ms": time_cuda(call) if call else None,
                            "device_ms": kernel_device_ms(call or lin_call, kernel),
                            "plain_ms": time_cuda(plain) if plain else None, "bound_ms": t,
                            "bound_by": by, "library_ms": None})
        log(f"LM-iteration kernels at {cell_name}'s shapes (K {K}, M {M}, D {D}, {n_live} live and "
            f"{n_cons} considered of {M * D} slots, pose table width {L}): against the plain "
            f"versions {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} of the largest value; "
            f"active count and the final pass's active mask exact; the accept test's cost the "
            f"linearization's to the bit; two calls the same bits")

        for e in entries[-4:]:
            timed = ("no call of its own (inside gba_linearize's)" if e["ms"] is None else
                     f"event ms {e['ms']:.4f} (the wrapper's call), plain {e['plain_ms']:.4f} ms")
            log(f"  {e['name']}: {e['launches']} launches in one solve of the cell; {timed}, "
                f"device ms {e['device_ms']:.4f}, bound {e['bound_ms']:.4f} ms by {e['bound_by']}")
    return entries


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

    def apply_event(self, ev, **kw):
        t0 = time.perf_counter()
        out = orig["apply"](self, ev, **kw)
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


# phase 11: the KITTI drivers on a sequence written to disk
N_KITTI = 41              # frames of the sequence (phase 2's canyon)
RESUME_FROM = 20          # the atlas-loading run drives frames RESUME_FROM.. again
N_DISTORTED = 11          # frames through the distorted camera
DEPTH_FACTOR = 256.0      # RGBD.DepthMapFactor of the settings (KITTI's depth PNG scale)
DISTORTION = dict(k1=-0.02, k2=0.005, p1=2e-4, p2=-1e-4)   # ~11 px at the image corners
RGB_FILTERS = (0, 1, 2, 3, 4)   # the image PNGs' row filters, in turn: every kind decoded
VISIBILITY = ("lm_visible", "lm_found")   # bumped by tracking in localization mode too


def settings_yaml(cfg, path: str, distortion=None):
    """A legacy flat-key settings file (``Examples/RGB-L/KITTI00-02.yaml``'s
    key set) with ``cfg``'s constants, ``DEPTH_FACTOR`` and ``distortion``."""
    cam, o, lc = cfg.camera, cfg.orb, cfg.lidar
    d = {**dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0), **(distortion or {})}
    lines = ["%YAML:1.0", "---", 'Camera.type: "PinHole"',
             f"Camera.fx: {cam.fx}", f"Camera.fy: {cam.fy}", f"Camera.cx: {cam.cx}",
             f"Camera.cy: {cam.cy}"] + [f"Camera.{k}: {v}" for k, v in d.items()] + [
        f"Camera.width: {cam.width}", f"Camera.height: {cam.height}", f"Camera.fps: {cfg.fps}",
        f"Camera.bf: {cam.bf}", "Camera.RGB: 1", f"ThDepth: {cam.th_depth}",
        f"RGBD.DepthMapFactor: {DEPTH_FACTOR}", f'LiDAR.Method: "{lc.method}"',
        f"LiDAR.min_dist: {lc.min_dist}", f"LiDAR.max_dist: {lc.max_dist}",
        f'LiDAR.MethodInverseDilation.KernelType: "{lc.dil_kernel_type}"',
        f"LiDAR.MethodInverseDilation.KernelSize_u: {lc.dil_kernel_size_u}",
        f"LiDAR.MethodInverseDilation.KernelSize_v: {lc.dil_kernel_size_v}",
        f"ORBextractor.nFeatures: {o.n_features}", f"ORBextractor.scaleFactor: {o.scale_factor}",
        f"ORBextractor.nLevels: {o.n_levels}", f"ORBextractor.iniThFAST: {o.ini_th_fast}",
        f"ORBextractor.minThFAST: {o.min_th_fast}"]
    tr = np.asarray(lc.T_velo_cam).reshape(3, 4)
    lines += [f"LiDAR.Tr{r + 1}{c + 1}: {float(tr[r, c])!r}" for r in range(3) for c in range(4)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def rgb_of(gray: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """8-bit RGB of a rendered gray image: the gray with small per-channel
    offsets, so that the decoder's RGB → gray weights matter."""
    g = np.clip(np.round(gray), 0, 255).astype(np.int16)
    off = rng.integers(-3, 4, g.shape + (3,), dtype=np.int16)
    return np.clip(g[..., None] + off, 0, 255).astype(np.uint8)


def gray_of(rgb: np.ndarray) -> np.ndarray:
    """libpng's RGB → gray, as ``cv2.IMREAD_GRAYSCALE`` gives it."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.float32)


def write_sequence(root: str, cfg, frames, depths, times):
    """A KITTI odometry sequence directory: ``image_2`` (8-bit RGB PNG),
    ``depth`` (16-bit PNG, metres × ``DEPTH_FACTOR``), ``velodyne`` (float32
    .bin), ``times.txt``, ``calib.txt``. Returns the gray each image must
    decode to."""
    rng = np.random.default_rng(SEED)
    for sub in ("image_2", "depth", "velodyne"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    expect = []
    for i, ((img, pts, _), dep) in enumerate(zip(frames, depths)):
        rgb = rgb_of(img.cpu().numpy(), rng)
        expect.append(gray_of(rgb))
        write_png(os.path.join(root, "image_2", f"{i:06d}.png"), rgb, RGB_FILTERS)
        d16 = np.clip(np.round(dep.cpu().numpy() * DEPTH_FACTOR), 0, 65535).astype(np.uint16)
        write_png(os.path.join(root, "depth", f"{i:06d}.png"), d16)
        if pts is not None:
            pts.cpu().numpy().astype(np.float32).tofile(
                os.path.join(root, "velodyne", f"{i:06d}.bin"))
    np.savetxt(os.path.join(root, "times.txt"), np.asarray(times))
    cam = cfg.camera
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"P2: {cam.fx} 0 {cam.cx} 0 0 {cam.fy} {cam.cy} 0 0 0 1 0\n")
        f.write("Tr: " + " ".join(repr(float(v)) for v in cfg.lidar.T_velo_cam) + "\n")
    return expect


def dense_depths(cfg, frames, device):
    """Each frame's dense depth image (metres): the port's
    ``compute_depth_from_pointcloud`` of its LiDAR sweep."""
    cam, lc = cfg.camera, cfg.lidar
    P = lidar_projection(cfg, device)
    kp = torch.zeros((1, 2), device=device)
    out = []
    for _, pts, mask in frames:
        _, _, dense = depth_ops.compute_depth_from_pointcloud(
            pts, P, kp, kp, height=cam.height, width=cam.width, bf=cam.bf, method=lc.method,
            min_dist=lc.min_dist, max_dist=lc.max_dist, dil_kind=lc.dil_kernel_type,
            dil_ku=lc.dil_kernel_size_u, dil_kv=lc.dil_kernel_size_v, valid_mask=mask)
        out.append(dense)
    return out


def through_distortion(cam, images, mode: str = "bilinear"):
    """``images`` (pinhole frames of ``cam`` without its distortion) as the
    distorted camera ``cam`` sees them: each of its pixels samples the
    pinhole frame where its undistorted coordinate lands (``grid_sample`` on
    the frames' device)."""
    from orb_slam3_rgbl_tpu_torch.geometry.camera import undistort_points

    dev = images[0].device
    v, u = torch.meshgrid(torch.arange(cam.height, dtype=torch.float32, device=dev),
                          torch.arange(cam.width, dtype=torch.float32, device=dev), indexing="ij")
    src = undistort_points(cam, torch.stack([u, v], dim=-1))
    grid = torch.stack([src[..., 0] / (cam.width - 1) * 2 - 1,
                        src[..., 1] / (cam.height - 1) * 2 - 1], dim=-1)[None]
    return [torch.nn.functional.grid_sample(x[None, None], grid, mode=mode, padding_mode="border",
                                            align_corners=True)[0, 0] for x in images]


def distort(cfg, images, depths):
    """The frames as a camera with ``DISTORTION`` sees them (bilinear for the
    image, nearest for depth)."""
    cam = dataclasses.replace(cfg.camera, **DISTORTION)
    return through_distortion(cam, images), through_distortion(cam, depths, "nearest")


@contextlib.contextmanager
def spy_drivers(rec: dict):
    """Per frame of a driver run: the tracking stages it ran, the image it
    gave the System, the images it decoded in this process (gray, with ms),
    the depth PNGs it read (ms); ``on_first`` (called once with the System
    after its first frame)."""
    from orb_slam3_rgbl_tpu_torch.io import kitti as kitti_mod, png as png_mod

    calls = []
    t_rgbl, t_rgbd, t_stereo = System.track_rgbl, System.track_rgbd, System.track_stereo
    load_gray, read_png = kitti_mod.load_image_gray, png_mod.read_png

    def tracked(fn):
        def wrapper(self, *a, **k):
            calls.clear()
            rec["given"].append(a[0])
            res = fn(self, *a, **k)
            rec["frame_calls"].append(list(calls))
            if len(rec["frame_calls"]) == 1 and rec.get("on_first") is not None:
                rec["on_first"](self, res)
            return res
        return wrapper

    def timed_gray(path):
        t = time.perf_counter()
        img = load_gray(path)
        rec["gray"].append((img, (time.perf_counter() - t) * 1e3))
        return img

    def timed_png(path):
        t = time.perf_counter()
        out = read_png(path)
        if os.sep + "depth" + os.sep in path:
            rec["depth_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    System.track_rgbl, System.track_rgbd = tracked(t_rgbl), tracked(t_rgbd)
    System.track_stereo = tracked(t_stereo)
    kitti_mod.load_image_gray, png_mod.read_png = timed_gray, timed_png
    try:
        with spy(calls, []):
            yield
    finally:
        System.track_rgbl, System.track_rgbd, System.track_stereo = t_rgbl, t_rgbd, t_stereo
        kitti_mod.load_image_gray, png_mod.read_png = load_gray, read_png


def run_driver(module, argv, device, on_first=None):
    """One driver run under ``spy_drivers``, the launch counts set to 0 just
    before it: (System, TrackResults, host s, record, launch counts)."""
    rec = {"frame_calls": [], "given": [], "gray": [], "depth_ms": [], "on_first": on_first}
    cuda_build.reset_launch_counts()
    with spy_drivers(rec):
        slam, results, times = module.run(module.parse_args(argv + ["--device", device.type]))
    return slam, results, times, rec, dict(cuda_build.launch_counts)


def check_run(what: str, results, rec, counts, expect_gray, traj, first: int,
              fused_from, check_fused: bool = True):
    """Phase 11's hard checks of one driver run: every frame OK with at
    least ``MIN_INLIERS``, fused from frame ``fused_from`` on (never with
    None; unchecked without ``check_fused``), 1 K1 + 1 K2 a frame, the
    images given to the System equal to ``expect_gray`` (unless None),
    the error against ground truth (frames ``first``..) under the bound, one
    finite pose a line in ``CameraTrajectory.txt``."""
    n = len(results)
    states = [r.state for r in results]
    inliers = [r.n_inliers for r in results]
    if any(s != trk.OK for s in states) or min(inliers) < MIN_INLIERS:
        fail(f"{what}: states {[trk.STATE_NAMES[s] for s in states]}, inliers {inliers}; every "
             f"frame must be OK with >= {MIN_INLIERS}")
    fused = ["_accept_fused" in c for c in rec["frame_calls"]]
    if check_fused and fused_from is None and any(fused):
        fail(f"{what}: fused frames {[i for i, f in enumerate(fused) if f]}; expected none")
    if check_fused and fused_from is not None and not all(fused[fused_from:]):
        fail(f"{what}: fused frames {[i for i, f in enumerate(fused) if f]}; expected "
             f"{fused_from}..{n - 1}")
    if counts.get("fast_and_blur") != n or counts.get("brief_continuous") != n:
        fail(f"{what}: launch counts {counts} over {n} frames; expected 1 K1 and 1 K2 a frame")
    if expect_gray is not None and (len(rec["given"]) != n or any(
            not np.array_equal(g, e) for g, e in zip(rec["given"], expect_gray))):
        fail(f"{what}: a decoded image differs from the numpy RGB -> gray of its PNG")
    est = np.stack([lie.np_se3_centers(r.pose) for r in results])
    errs = np.linalg.norm(est - (traj[first:first + n, 4:7] - traj[0, 4:7]), axis=1)
    bound = MAX_TRANS_ERR_M * max(1.0, (first + n) / N_DRIVE)
    if not float(errs.max()) < bound:
        fail(f"{what}: translation error {errs.max():.3f} m >= {bound:.3f} m")
    return errs, fused


def phase11_kitti(cfg, traj, frames, device, workdir: str):
    """The two KITTI drivers as users run them, on the canyon written to
    disk as a KITTI sequence (``write_sequence``): the RGB-L driver with
    ``--stats``; the RGB-D driver with ``--save-atlas``; a fresh RGB-D driver
    with ``--load-atlas`` over frames ``RESUME_FROM``.. again (relocalized on
    the first, then in localization mode); the RGB-D driver over
    ``N_DISTORTED`` frames of a distorted camera (per-stage path)."""
    from orb_slam3_rgbl_tpu_torch.examples import run_kitti_rgbd, run_kitti_rgbl

    n = len(frames)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    depths = dense_depths(cfg, frames, device)
    seq = os.path.join(workdir, "seq")
    expect = write_sequence(seq, cfg, frames, depths, [i * 0.1 for i in range(n)])
    settings = os.path.join(workdir, "settings.yaml")
    settings_yaml(cfg, settings)
    # the revisit: frames RESUME_FROM.. again, later in time
    revisit = os.path.join(workdir, "revisit")
    for sub in ("image_2", "depth"):
        os.makedirs(os.path.join(revisit, sub))
        for k, i in enumerate(range(RESUME_FROM, n)):
            os.symlink(os.path.join(seq, sub, f"{i:06d}.png"),
                       os.path.join(revisit, sub, f"{k:06d}.png"))
    np.savetxt(os.path.join(revisit, "times.txt"),
               n * 0.1 + 0.1 * np.arange(n - RESUME_FROM))
    # the distorted camera's frames and settings
    dimg, ddep = distort(cfg, [f[0] for f in frames[:N_DISTORTED]], depths[:N_DISTORTED])
    dist_seq = os.path.join(workdir, "distorted")
    expect_d = write_sequence(dist_seq, cfg, [(i, None, None) for i in dimg], ddep,
                              [i * 0.1 for i in range(N_DISTORTED)])
    dist_settings = os.path.join(workdir, "distorted.yaml")
    settings_yaml(cfg, dist_settings, DISTORTION)
    log(f"phase 11: wrote a {n}-frame KITTI sequence ({cfg.camera.width}x{cfg.camera.height} RGB "
        f"PNGs with row filters {RGB_FILTERS}, 16-bit depth PNGs, {frames[0][1].shape[0]}-point "
        f".bin clouds) and {N_DISTORTED} distorted frames in {time.perf_counter() - t0:.1f} s")

    # ---- the RGB-L driver ---------------------------------------------------
    out = os.path.join(workdir, "rgbl_traj.txt")
    stats = os.path.join(workdir, "rgbl_stats.txt")
    slam, results, times, rec, counts = run_driver(
        run_kitti_rgbl, [settings, seq, "--out", out, "--stats", stats], device)
    errs, _ = check_run("RGB-L driver", results, rec, counts, expect, traj, 0, 2)
    rows = np.loadtxt(out)
    if rows.shape != (n, 12) or not np.isfinite(rows).all():
        fail(f"RGB-L driver: CameraTrajectory.txt holds {rows.shape}, expected ({n}, 12) finite")
    ms = np.asarray(times) * 1e3
    load_ms = np.asarray(slam.timer.samples["load"]) * 1e3
    log(f"RGB-L driver: {n} frames, all OK, fused from frame 2, {slam.map.n_kf} keyframes, "
        f"launches {counts}; host ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f}; max "
        f"trans err {errs.max():.3f} m; the wait for the prefetching loader's frame (RGB PNGs, "
        f"filters {RGB_FILTERS}, decoded in worker processes) ms median "
        f"{np.median(load_ms):.2f}, frame 0 {load_ms[0]:.2f}")
    log("  StageTimer (--stats):")
    for line in open(stats).read().splitlines():
        log("    " + line)
    del slam

    # ---- the RGB-D driver, saving the atlas ----------------------------------
    atlas = os.path.join(workdir, "atlas.npz")
    io_ms = {}
    save, load = System.save_atlas, System.load_atlas

    def timed(fn, key):
        def wrapper(self, *a, **k):
            t = time.perf_counter()
            fn(self, *a, **k)
            io_ms[key] = (time.perf_counter() - t) * 1e3
        return wrapper

    System.save_atlas, System.load_atlas = timed(save, "save"), timed(load, "load")
    try:
        slam, results, times, rec, counts = run_driver(
            run_kitti_rgbd, [settings, seq, "--out", os.path.join(workdir, "rgbd_traj.txt"),
                             "--save-atlas", atlas], device)
        errs, _ = check_run("RGB-D driver", results, rec, counts, expect, traj, 0, 2)
        n_kf_saved = slam.map.n_kf
        ms = np.asarray(times) * 1e3
        log(f"RGB-D driver: {n} frames, all OK, fused from frame 2, {n_kf_saved} keyframes, "
            f"launches {counts}; host ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f}; "
            f"max trans err {errs.max():.3f} m; decode ms/PNG RGB median "
            f"{statistics.median([m for _, m in rec['gray']]):.2f}, 16-bit depth median "
            f"{statistics.median(rec['depth_ms']):.2f}; save_atlas {io_ms['save']:.1f} ms, "
            f"{os.path.getsize(atlas)} bytes")
        del slam

        # ---- a fresh RGB-D driver loading it: relocalization, then localization
        frozen = {}

        def on_first(sysm, res):
            if res.state != trk.OK:
                fail(f"load_atlas: the first frame of the revisit is {trk.STATE_NAMES[res.state]}; "
                     "expected OK through relocalization")
            frozen["reloc_frame"] = sysm.tracker.last_reloc_frame
            frozen["maps"] = sysm.atlas.n_maps()
            sysm.activate_localization_mode()
            m = sysm.map
            frozen["arrays"] = {f.name: getattr(m, f.name).copy()
                                for f in dataclasses.fields(m)
                                if isinstance(getattr(m, f.name), np.ndarray)}
            frozen["counters"] = (m.n_kf, m.n_lm, m.version)

        slam, results, times, rec, counts = run_driver(
            run_kitti_rgbd, [settings, revisit, "--out", os.path.join(workdir, "resume.txt"),
                             "--load-atlas", atlas], device, on_first=on_first)
    finally:
        System.save_atlas, System.load_atlas = save, load
    errs, fused = check_run("load_atlas + localization", results, rec, counts,
                            expect[RESUME_FROM:], traj, RESUME_FROM, None, check_fused=False)
    m = slam.map
    if frozen.get("maps") != 1 or slam.atlas.n_maps() != 1:
        fail(f"load_atlas: {frozen.get('maps')} / {slam.atlas.n_maps()} atlas maps, expected 1")
    if frozen.get("reloc_frame") != n:
        fail(f"load_atlas: relocalized at frame {frozen.get('reloc_frame')}, expected frame {n}")
    if any(r.created_kf for r in results[1:]) or (m.n_kf, m.n_lm, m.version) != frozen["counters"]:
        fail(f"localization mode made a keyframe or moved the map: {(m.n_kf, m.n_lm, m.version)} "
             f"against {frozen['counters']}")
    moved = [k for k, v in frozen["arrays"].items()
             if k not in VISIBILITY and not np.array_equal(getattr(m, k), v)]
    if moved:
        fail(f"localization mode changed the map's arrays {moved}")
    ms = np.asarray(times) * 1e3
    log(f"load_atlas + localization mode: {len(results)} frames of the revisit, all OK, "
        f"relocalized on the first (frame {n}) into 1 atlas map, then no keyframe and every map "
        f"array but {VISIBILITY} unchanged to the bit; fused frames "
        f"{[i for i, f in enumerate(fused) if f]}; launches {counts}; load_atlas "
        f"{io_ms['load']:.1f} ms; host ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f}; "
        f"max trans err {errs.max():.3f} m")
    del slam

    # ---- the distorted camera: the per-stage path ------------------------------
    slam, results, times, rec, counts = run_driver(
        run_kitti_rgbd, [dist_settings, dist_seq, "--out", os.path.join(workdir, "dist.txt")],
        device)
    errs, _ = check_run("distorted camera", results, rec, counts, expect_d, traj, 0, None)
    if slam._undistort_cam is None or slam._fast is not None:
        fail("distorted camera: the System did not undistort, or it built the fused step")
    ms = np.asarray(times) * 1e3
    log(f"distorted camera ({DISTORTION}): {len(results)} frames, all OK, none fused, launches "
        f"{counts}; host ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f}; max trans err "
        f"{errs.max():.3f} m")
    del slam
    if device.type == "cuda":
        log(f"phase 11 peak memory {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")


# phase 12: the stereo and monocular sensors
# the camera of the reference's Examples/Stereo/KITTI00-02.yaml
STEREO_CAMERA = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
                     th_depth=35.0)
N_UNRECTIFIED = 11            # frames of the unrectified pair
RIGHT_TURN_DEG = 0.5          # the unrectified right camera's turn about its y axis
DISTORTION_R = dict(k1=-0.018, k2=0.004, p1=-1e-4, p2=2e-4)   # the unrectified right camera's
BASELINE_REL_TOL = 1e-3       # cam_rect.bf / fx against the calibrated baseline
MONO_INIT_BY = 12             # tests/test_mono.py's bound on the first OK frame
# every frame of the monocular drive from this one on takes the fused step:
# rehearsed on the CPU at this width over these frames, the port initialized
# on frame 8 and fused from frame 10, the JAX System on frame 9 and from 11
# (the two-view RANSACs draw from different streams)
MONO_FUSED_FROM = 11


def stereo_config():
    """Phase 2's configuration with the STEREO sensor and the stereo camera
    of ``Examples/Stereo/KITTI00-02.yaml``, mapping and loop closing on."""
    cfg = kitti_synthetic_config()
    return dataclasses.replace(cfg, sensor=STEREO, loop_closing=True,
                               camera=dataclasses.replace(cfg.camera, **STEREO_CAMERA))


def compose_pose(Twc: np.ndarray, T12: np.ndarray) -> np.ndarray:
    """World pose (7,) of a camera at ``T12`` (4×4, its pose in the frame of
    the camera at ``Twc``)."""
    q12 = lie.matrix_to_quat(torch.as_tensor(T12[:3, :3], dtype=torch.float32)).numpy()
    q, t = Twc[:4].astype(np.float32), Twc[4:7].astype(np.float32)
    return np.concatenate([lie.np_quat_mul(q, q12),
                           t + lie.np_quat_rotate(q, T12[:3, 3].astype(np.float32))])


def render_views(cfg, traj, T12, device, seed: int = SEED):
    """The canyon's images from the camera at pose ``T12`` relative to each
    pose of ``traj`` (set-up work, on ``device``)."""
    cam = cfg.camera
    world = syn.make_world(seed, device=device)
    return [syn.render_image(world, compose_pose(Twc, T12), cam.fx, cam.fy, cam.cx, cam.cy,
                             cam.height, cam.width).contiguous() for Twc in traj]


def baseline_pose(cfg) -> np.ndarray:
    T = np.eye(4)
    T[0, 3] = cfg.camera.bf / cfg.camera.fx
    return T


@contextlib.contextmanager
def spy_stereo(rec: list):
    """Per call of ``refine_stereo_subpixel``: valid left keypoints, those
    with a stereo depth before it, those it refined, those with depth after."""
    orig = frame_mod.refine_stereo_subpixel

    def recorded(feats, *a, **k):
        out = orig(feats, *a, **k)
        rec.append(torch.stack([feats.valid.sum(), (feats.depth > 0).sum(),
                                (out.u_right != feats.u_right).sum(),
                                (out.depth > 0).sum()]))
        return out

    frame_mod.refine_stereo_subpixel = recorded
    try:
        yield
    finally:
        frame_mod.refine_stereo_subpixel = orig


def profile_call(fn, iters: int = 5):
    """(device ms, kernels) per call of ``fn`` under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with _profile() as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if _on_device(e)]
    return sum(_ms(e) for e in dev) / iters, len(dev) / iters


def stereo_drive(sysm, lefts, rights, device):
    """``System.track_stereo`` over the pairs: per-frame (TrackResult, host
    ms, tracking stages run)."""
    out, calls = [], []
    with spy(calls, []):
        for i, (left, right) in enumerate(zip(lefts, rights)):
            calls.clear()
            t = time.perf_counter()
            res = sysm.track_stereo(left, right, i * 0.1)
            _synchronize(device)
            out.append((res, (time.perf_counter() - t) * 1e3, list(calls)))
    return out


def phase12_stereo(cfg, traj, lefts, device):
    """``System(cfg).track_stereo`` over the canyon's pairs (rectified input,
    mapping and loop closing on, natural keyframe policy)."""
    n = len(lefts)
    t0 = time.perf_counter()
    rights = render_views(cfg, traj[:n], baseline_pose(cfg), device)
    _synchronize(device)
    log(f"phase 12: rendered {n} right images at the baseline bf/fx = "
        f"{cfg.camera.bf / cfg.camera.fx:.4f} m in {time.perf_counter() - t0:.1f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    sysm = System(cfg, device=device)
    refine, jobs = [], []
    with spy_stereo(refine), spy_mapping(jobs, [], contextlib.nullcontext):
        rows = stereo_drive(sysm, lefts, rights, device)
    counts = dict(cuda_build.launch_counts)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 if device.type == "cuda" else 0.0
    results = [(r, ms) for r, ms, _ in rows]
    states = [r.state for r, _ in results]
    inliers = [r.n_inliers for r, _ in results[1:]]
    errs = trans_errors(traj, results)
    if any(st != trk.OK for st in states) or min(inliers) < MIN_INLIERS:
        fail(f"stereo: states {[trk.STATE_NAMES[st] for st in states]}, inliers {inliers}; every "
             f"frame must be OK with >= {MIN_INLIERS}")
    if counts.get("fast_and_blur") != 2 * n or counts.get("brief_continuous") != 2 * n:
        fail(f"stereo: launch counts {counts} over {n} frames; expected 2 K1 and 2 K2 a frame")
    if any("_accept_fused" in c for _, _, c in rows):
        fail("stereo: a frame took the fused step (the stereo sensor has none)")
    if not float(errs.max()) < MAX_TRANS_ERR_M:
        fail(f"stereo: translation error {errs.max():.3f} m >= {MAX_TRANS_ERR_M} m")
    faults = [(k, f) for k, _, f in jobs if f]
    if faults:
        fail(f"stereo: binding faults after mapping jobs {faults[:3]}")
    share = torch.stack(refine).double().cpu().numpy()
    before, refined, after = (share[:, i] / share[:, 0] for i in (1, 2, 3))
    kf = [r.created_kf for r, _ in results]
    timed = range(1, n)
    for kind, idx in (("keyframe", [i for i in timed if kf[i]]),
                      ("no keyframe", [i for i in timed if not kf[i]])):
        ms = [results[i][1] for i in idx]
        if ms:
            log(f"stereo host ms/frame, {kind}: {_median_p90(ms)}")
    # the row matcher alone, on a frame's features
    fl, fr = (compiled_extract(cfg, im, device) for im in (lefts[n // 2], rights[n // 2]))
    sf = torch.tensor([cfg.orb.scale_factor ** l for l in range(cfg.orb.n_levels)],
                      device=device)
    match_ms, match_kernels = profile_call(lambda: stereo_row_match(
        fl.desc, fl.uv[:, 1], fl.valid, fr.desc, fr.uv[:, 0], fr.uv[:, 1], fr.valid,
        fr.octave, 0.0, cfg.camera.bf / 0.5, fl.uv[:, 0], sf))
    log(f"stereo (rectified): {n} frames, all OK, none fused, {sysm.map.n_kf} keyframes, "
        f"{len(jobs)} mapping jobs (bindings consistent after each), launches {counts} (2 K1 + "
        f"2 K2 a frame); valid left keypoints with a stereo depth: {before.mean():.4f} mean "
        f"({before.min():.4f}-{before.max():.4f}) before the SAD refinement, {after.mean():.4f} "
        f"after it, {refined.mean():.4f} refined to a subpixel column; stereo_row_match "
        f"({fl.uv.shape[0]} x {fr.uv.shape[0]} slots) {match_ms:.4f} ms device in "
        f"{match_kernels:.0f} kernels; max trans err {errs.max():.3f} m (bound "
        f"{MAX_TRANS_ERR_M}); peak memory {peak_mb:.0f} MiB")
    del sysm
    return rights


def stereo_settings_yaml(cfg, path: str, T12: np.ndarray, dist_l: dict, dist_r: dict):
    """A ``File.version: "1.0"`` settings file of a calibrated pair that needs
    rectifying: ``Camera1`` / ``Camera2`` with their distortion and
    ``Stereo.T_c1_c2`` (``cfg``'s ORB settings)."""
    cam, o = cfg.camera, cfg.orb
    lines = ["%YAML:1.0", 'File.version: "1.0"', 'Camera.type: "PinHole"']
    for k, dist in (("Camera1", dist_l), ("Camera2", dist_r)):
        lines += [f"{k}.fx: {cam.fx}", f"{k}.fy: {cam.fy}", f"{k}.cx: {cam.cx}",
                  f"{k}.cy: {cam.cy}"] + [f"{k}.{d}: {v}" for d, v in dist.items()]
    lines += [f"Camera.width: {cam.width}", f"Camera.height: {cam.height}",
              f"Camera.fps: {cfg.fps}", f"Stereo.ThDepth: {cam.th_depth}",
              "Stereo.T_c1_c2: !!opencv-matrix", "  rows: 4", "  cols: 4", "  dt: f",
              "  data: [" + ", ".join(repr(float(v)) for v in T12.reshape(-1)) + "]",
              f"ORBextractor.nFeatures: {o.n_features}", f"ORBextractor.scaleFactor: {o.scale_factor}",
              f"ORBextractor.nLevels: {o.n_levels}", f"ORBextractor.iniThFAST: {o.ini_th_fast}",
              f"ORBextractor.minThFAST: {o.min_th_fast}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def phase12_unrectified(cfg, traj, lefts, device, workdir: str):
    """A calibrated pair that needs rectifying: the right camera turned by
    ``RIGHT_TURN_DEG`` about y, both images through a radial-tangential
    distortion, a ``Camera2`` settings file; the System rectifies each pair
    (``geometry/rectify.py``) and tracks on the rectified camera."""
    from orb_slam3_rgbl_tpu_torch.config import load_config
    from orb_slam3_rgbl_tpu_torch.geometry.rectify import stereo_rectify

    n = N_UNRECTIFIED
    a = np.deg2rad(RIGHT_TURN_DEG)
    T12 = baseline_pose(cfg)
    T12[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    cam_l = dataclasses.replace(cfg.camera, **DISTORTION)
    cam_r = dataclasses.replace(cfg.camera, **DISTORTION_R)
    img_l = through_distortion(cam_l, lefts[:n])
    img_r = through_distortion(cam_r, render_views(cfg, traj[:n], T12, device))
    settings = os.path.join(workdir, "stereo_camera2.yaml")
    stereo_settings_yaml(cfg, settings, T12, DISTORTION, DISTORTION_R)
    ucfg = dataclasses.replace(load_config(settings, sensor=STEREO), loop_closing=True)
    sysm = System(ucfg, device=device)
    if sysm.rectifier is None:
        fail("unrectified stereo: the System built no rectifier for a Camera2 settings file")
    rect = sysm.cam
    base = float(np.linalg.norm(T12[:3, 3]))
    rel = abs(rect.bf / rect.fx - base) / base
    if not rel < BASELINE_REL_TOL:
        fail(f"unrectified stereo: cam_rect.bf / fx = {rect.bf / rect.fx:.6f} m against the "
             f"baseline {base:.6f} m ({rel:.2e} relative)")
    cuda_build.reset_launch_counts()
    rows = stereo_drive(sysm, img_l, img_r, device)
    counts = dict(cuda_build.launch_counts)
    # the System's world is the rectified left camera of frame 0: turned by
    # R1 from the left camera, whose frame the ground truth is in
    c = ucfg.camera
    K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1.0]])
    T21 = np.linalg.inv(T12)
    R1 = stereo_rectify(K, np.array([cam_l.k1, cam_l.k2, cam_l.p1, cam_l.p2, cam_l.k3]), K,
                        np.array([cam_r.k1, cam_r.k2, cam_r.p1, cam_r.p2, cam_r.k3]),
                        (c.width, c.height), T21[:3, :3], T21[:3, 3])[0]
    est = np.stack([lie.np_se3_centers(r.pose) for r, _, _ in rows]) @ R1
    errs = np.linalg.norm(est - (traj[:n, 4:7] - traj[0, 4:7]), axis=1)
    states = [r.state for r, _, _ in rows]
    bound = MAX_TRANS_ERR_M * n / N_DRIVE
    if any(st != trk.OK for st in states):
        fail(f"unrectified stereo: states {[trk.STATE_NAMES[st] for st in states]}")
    if counts.get("fast_and_blur") != 2 * n or counts.get("brief_continuous") != 2 * n:
        fail(f"unrectified stereo: launch counts {counts}; expected 2 K1 and 2 K2 a frame")
    if not float(errs.max()) < bound:
        fail(f"unrectified stereo: translation error {errs.max():.3f} m >= {bound:.3f} m")
    log(f"stereo (unrectified, right camera turned {RIGHT_TURN_DEG} deg, distortion {DISTORTION} "
        f"/ {DISTORTION_R}): rectified camera fx {rect.fx:.3f} cx {rect.cx:.3f} cy {rect.cy:.3f} "
        f"bf {rect.bf:.4f} (baseline {rect.bf / rect.fx:.6f} m, {rel:.2e} from {base:.6f}); "
        f"{n} frames, all OK, launches {counts}; host ms/frame "
        f"{_median_p90([ms for _, ms, _ in rows[1:]])}; max trans err {errs.max():.3f} m "
        f"(bound {bound:.3f})")


def phase12_mono(traj, frames, device):
    """``System(cfg).track_monocular`` over phase 2's frames (mapping and
    loop closing on): two-view initialization, then the fused step without
    a depth source."""
    cfg = dataclasses.replace(kitti_synthetic_config(), sensor=MONOCULAR, loop_closing=True)
    n = len(frames)
    sysm = System(cfg, device=device)
    calls, rows = [], []
    cuda_build.reset_launch_counts()
    with spy(calls, []):
        for i, (img, _, _) in enumerate(frames):
            calls.clear()
            t = time.perf_counter()
            res = sysm.track_monocular(img, i * 0.1)
            _synchronize(device)
            rows.append((res, (time.perf_counter() - t) * 1e3, "_accept_fused" in calls))
    counts = dict(cuda_build.launch_counts)
    states = [r.state for r, _, _ in rows]
    first = states.index(trk.OK) if trk.OK in states else n
    fused = [i for i, (_, _, f) in enumerate(rows) if f]
    if first > MONO_INIT_BY or any(st != trk.OK for st in states[first:]):
        fail(f"mono: states {[trk.STATE_NAMES[st] for st in states]}; initialization by frame "
             f"{MONO_INIT_BY}, then every frame OK")
    if fused != list(range(fused[0] if fused else n, n)) or not fused \
            or fused[0] > MONO_FUSED_FROM or fused[0] < first + 2:
        fail(f"mono: fused frames {fused}, expected every frame from frame {first + 2} (two "
             f"after the initialization) or from {MONO_FUSED_FROM} at the latest")
    if counts.get("fast_and_blur") != n or counts.get("brief_continuous") != n:
        fail(f"mono: launch counts {counts} over {n} frames; expected 1 K1 and 1 K2 a frame")
    check_no_sync(sysm.tracker, (frames[-1][0], frames[-1][0], None), device)
    gt = traj[first:n, 4:7]
    est = sysm.trajectory()[first:n, 4:7]
    ate = float(align.ate_rmse(torch.as_tensor(gt, dtype=torch.float32),
                               torch.as_tensor(est, dtype=torch.float32), with_scale=True))
    if not ate < MAX_TRANS_ERR_M:
        fail(f"mono: Sim3-aligned ATE {ate:.3f} m >= {MAX_TRANS_ERR_M} m")
    classic = [ms for i, (_, ms, f) in enumerate(rows) if i > first and not f]
    log(f"mono: initialized on frame {first} ({rows[first][1]:.1f} ms host), fused from frame "
        f"{fused[0]}, {sysm.map.n_kf} keyframes, {int(sysm.map.lm_valid.sum())} "
        f"landmarks, launches {counts} (1 K1 + 1 K2 a frame); host ms/frame before "
        f"initialization {_median_p90([ms for _, ms, _ in rows[:first]])}, classic after it "
        f"{_median_p90(classic) if classic else 'none'}, fused "
        f"{_median_p90([ms for _, ms, f in rows if f])}; Sim3-aligned ATE {ate:.4f} m over "
        f"frames {first}..{n - 1} (bound {MAX_TRANS_ERR_M})")


def phase12_driver(cfg, traj, lefts, rights, device, workdir: str):
    """``run_kitti_stereo`` on phase 11's sequence with ``image_0`` and
    ``image_1`` (8-bit gray PNGs of the pairs) written beside its images."""
    from orb_slam3_rgbl_tpu_torch.examples import run_kitti_stereo

    seq = os.path.join(workdir, "seq")
    n = len(lefts)
    expect = []
    for sub, images in (("image_0", lefts), ("image_1", rights)):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
        for i, img in enumerate(images):
            g = np.clip(np.round(img.cpu().numpy()), 0, 255).astype(np.uint8)
            write_png(os.path.join(seq, sub, f"{i:06d}.png"), g, RGB_FILTERS)
            expect.append(g.astype(np.float32))
    settings = os.path.join(workdir, "stereo.yaml")
    settings_yaml(cfg, settings)
    out = os.path.join(workdir, "stereo_traj.txt")
    slam, results, times, rec, counts = run_driver(run_kitti_stereo, [settings, seq, "--out", out],
                                                   device)
    states = [r.state for r in results]
    if len(results) != n or any(st != trk.OK for st in states) or \
            min(r.n_inliers for r in results) < MIN_INLIERS:
        fail(f"stereo driver: states {[trk.STATE_NAMES[st] for st in states]}")
    if counts.get("fast_and_blur") != 2 * n or counts.get("brief_continuous") != 2 * n:
        fail(f"stereo driver: launch counts {counts}; expected 2 K1 and 2 K2 a frame")
    decoded = sorted(((g.shape, g.tobytes()) for g, _ in rec["gray"]))
    if decoded != sorted(((e.shape, e.tobytes()) for e in expect)):
        fail("stereo driver: a decoded image differs from the PNG written")
    rows = np.loadtxt(out)
    if rows.shape != (n, 12) or not np.isfinite(rows).all():
        fail(f"stereo driver: CameraTrajectory.txt holds {rows.shape}, expected ({n}, 12) finite")
    errs = np.linalg.norm(rows.reshape(n, 3, 4)[:, :, 3] - (traj[:n, 4:7] - traj[0, 4:7]), axis=1)
    if not float(errs.max()) < MAX_TRANS_ERR_M:
        fail(f"stereo driver: translation error {errs.max():.3f} m >= {MAX_TRANS_ERR_M} m")
    ms = np.asarray(times) * 1e3
    log(f"stereo KITTI driver: {n} pairs, all OK, {slam.map.n_kf} keyframes, launches {counts}; "
        f"host ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f}; decode ms/PNG (gray) "
        f"median {statistics.median([m for _, m in rec['gray']]):.2f}; one finite pose a line; "
        f"max trans err {errs.max():.3f} m")


def phase12(traj, frames, device, workdir: str, card: str):
    """The stereo and monocular sensors: the rectified pair, the pair that
    needs rectifying, the monocular drive and the stereo KITTI driver."""
    t0 = time.perf_counter()
    log(f"phase 12 on {card}")
    cfg = stereo_config()
    lefts = [img for img, _, _ in frames]
    rights = phase12_stereo(cfg, traj, lefts, device)
    phase12_unrectified(cfg, traj, lefts, device, workdir)
    phase12_mono(traj, frames, device)
    phase12_driver(cfg, traj, lefts, rights, device, workdir)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s on {card}")


# phase 13: the inertial sensors through the EuRoC driver
# the cameras, extrinsics and IMU of the reference's
# Examples/Stereo-Inertial/EuRoC.yaml (Camera1 = cam0, Camera2 = cam1)
EUROC_CAM1 = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480)
EUROC_DIST1 = dict(k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)
EUROC_CAM2 = dict(fx=457.587, fy=456.134, cx=379.999, cy=255.238)
EUROC_DIST2 = dict(k1=-0.28368365, k2=0.07451284, p1=-0.00010473, p2=-3.55590700e-05)
EUROC_T_C1_C2 = np.array([
    [0.999997256477797, -0.002317135723275, -0.000343393120620, 0.110074137800478],
    [0.002312067192432, 0.999898048507103, -0.014090668452683, -0.000156612054392],
    [0.000376008102320, 0.014089835846691, 0.999900662638081, 0.000889382785432],
    [0.0, 0.0, 0.0, 1.0]])
EUROC_T_B_C1 = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])
EUROC_IMU = {"IMU.NoiseGyro": 1.7e-4, "IMU.NoiseAcc": 2.0e-3, "IMU.GyroWalk": 1.9393e-5,
             "IMU.AccWalk": 3.0e-3, "IMU.Frequency": 200.0}
EUROC_FPS, IMU_HZ = 20, 200
EUROC_T0_NS = 1_000_000_000   # the first frame's stamp (1 s: float32 stays 1 µs fine)
N_EUROC = 160                 # frames written (8 s)
# frames each mode drives: stereo-inertial initializes ~1.3 s in (frame 25,
# bound 25) and then tracks ~1.2 s on the IMU; after the initialization a
# frame costs ~2 s of host time, so the 5 s to its VIBA1 would not fit the
# script's time limit: VIBA1 is run by `LocalMapper.maybe_viba` at the
# initialization's time + VIBA1_AFTER_S on the driven state, the call
# `System._post_track` makes every frame. Monocular-inertial needs its
# two-view initialization and 10 keyframes first (IMU on frame ~47, bound
# first OK + 40) and drives to VIBA1 (~151, by 157): before VIBA1 its scale
# and speed are still ~10% off (drives cut to 72, 84 or 96 frames on the CPU:
# scale 1.098-1.099, speed 7-12% off; 20% at 112), after it 0.4% and 2.5%
# on the H100
EUROC_MODE_FRAMES = {"stereo-inertial": 48, "mono-inertial": 160}
VIBA1_AFTER_S = 5.0           # LocalMapping.cc: VIBA1 5 s after the IMU initialization
ROOM_HALF = 10.0              # the box room's half width (m): walls ~10 m ahead
GRAVITY_TILT_DEG = 12.0       # gravity's tilt from the render world's +y
# bounds from the CPU rehearsals at this size (tests/rehearse_phase13.py,
# PERF.md §6): the IMU initializes at most this many frames after the
# first OK frame, the later of the port's and the JAX System's rehearsal,
# the JAX System under the reference's inertial rules that the port
# follows (stereo 25 and 25; monocular 40 and 40) — counted from the first
# OK frame, as the two-view initialization's own frame moves by a frame or
# two between the card's extraction and the CPU's; the error bounds are ~3×
# the port's rehearsal (gravity 0.33° stereo / 0.16° monocular, ATE 0.013 /
# 0.056 m, monocular scale 1.027, speed 0.1% / 6.6%)
IMU_INIT_BY = {"stereo-inertial": 25, "mono-inertial": 40}
MAX_GRAVITY_ERR_DEG = 1.0
MAX_SCALE_ERR = 0.10          # mono-inertial: |s − 1| of the Sim3 alignment after init
MAX_VEL_ERR = 0.20            # the last keyframe's speed, relative
MAX_ATE_M = {"stereo-inertial": 0.05, "mono-inertial": 0.17}


def euroc_motion(n_frames: int):
    """A hand-held motion in the box room, its ground truth and its IMU:
    smooth sinusoidal accelerations (~0.4–0.7 m/s²), mild rotation
    (≤ ~0.3 rad/s), a slow drift towards the far wall, gravity tilted by
    ``GRAVITY_TILT_DEG`` from the render world's down axis (+y). The camera
    (cam0) pose is analytic; the body is cam0 through ``EUROC_T_B_C1``; the
    IMU's rates and specific forces are central differences of the body
    pose in float64 (h = 1 ms). Returns (frame times (s), cam0 Twc (F, 7),
    body velocities (F, 3), IMU rows (S, 7) [t, ax, ay, az, gx, gy, gz],
    gravity in the render world)."""
    from scipy.spatial.transform import Rotation

    T_cb = np.linalg.inv(EUROC_T_B_C1)

    def cam_pose(t):
        p = np.array([0.25 * np.sin(2.1 * t) + 0.1 * t, 0.12 * np.sin(1.7 * t + 0.4),
                      0.3 * np.sin(1.3 * t + 1.0) + 1.0 * t - 7.0])
        R = Rotation.from_euler("yxz", [0.22 * np.sin(0.6 * t), 0.08 * np.sin(0.9 * t + 0.3),
                                        0.05 * np.sin(1.1 * t)]).as_matrix()
        return R, p

    def body_pose(t):
        R, p = cam_pose(t)
        return R @ T_cb[:3, :3], p + R @ T_cb[:3, 3]

    g = Rotation.from_rotvec(np.deg2rad(GRAVITY_TILT_DEG) * np.array([1.0, 0.0, 0.3]) /
                             np.linalg.norm([1.0, 0.0, 0.3])).apply([0.0, 9.81, 0.0])
    h = 1e-3
    times = np.arange(n_frames) / EUROC_FPS
    n_imu = int(round(times[-1] * IMU_HZ)) + 1
    rows = []
    for k in range(n_imu):
        t = k / IMU_HZ
        Rm, pm = body_pose(t - h)
        R0, p0 = body_pose(t)
        Rp, pp = body_pose(t + h)
        acc_w = (pp - 2 * p0 + pm) / (h * h)
        gyr = Rotation.from_matrix(Rm.T @ Rp).as_rotvec() / (2 * h)
        rows.append(np.concatenate([[t], R0.T @ (acc_w - g), gyr]))
    twc, vel = [], []
    for t in times:
        R, p = cam_pose(t)
        twc.append(np.concatenate([Rotation.from_matrix(R).as_quat()[[3, 0, 1, 2]], p]))
        vel.append((body_pose(t + h)[1] - body_pose(t - h)[1]) / (2 * h))
    return times, np.asarray(twc, np.float32), np.asarray(vel), np.asarray(rows), g


def write_euroc(root: str, times, lefts, rights, imu_rows):
    """An ASL-format sequence (``mav0/cam0``, ``cam1``, ``imu0``), 8-bit
    gray PNGs, and a timestamps file in nanoseconds. Returns (mav dir,
    timestamps file)."""
    mav = os.path.join(root, "mav0")
    stamps = [EUROC_T0_NS + int(round(t * 1e9)) for t in times]
    for cam, images in (("cam0", lefts), ("cam1", rights)):
        if images is None:
            continue
        os.makedirs(os.path.join(mav, cam, "data"))
        with open(os.path.join(mav, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for ns, img in zip(stamps, images):
                write_png(os.path.join(mav, cam, "data", f"{ns}.png"),
                          np.clip(np.rint(img.cpu().numpy()), 0, 255).astype(np.uint8))
                f.write(f"{ns},{ns}.png\n")
    os.makedirs(os.path.join(mav, "imu0"))
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for r in imu_rows:
            ns = EUROC_T0_NS + int(round(r[0] * 1e9))
            f.write(f"{ns}," + ",".join(repr(float(v)) for v in (*r[4:7], *r[1:4])) + "\n")
    ts_file = os.path.join(root, "timestamps.txt")
    with open(ts_file, "w") as f:
        f.write("\n".join(str(ns) for ns in stamps) + "\n")
    return mav, ts_file


def euroc_settings_yaml(path: str, n_features: int, stereo: bool):
    """The reference's EuRoC settings (``File.version: "1.0"``): Camera1,
    Camera2 and ``Stereo.T_c1_c2`` for the stereo pair, ``IMU.T_b_c1`` and the
    IMU noise, 20 fps, ORB 1.2 × 8 levels."""
    def matrix(name, M):
        return [f"{name}: !!opencv-matrix", "  rows: 4", "  cols: 4", "  dt: f",
                "  data: [" + ", ".join(repr(float(v)) for v in M.reshape(-1)) + "]"]

    lines = ["%YAML:1.0", 'File.version: "1.0"', 'Camera.type: "PinHole"']
    cams = (("Camera1", EUROC_CAM1, EUROC_DIST1),) + (
        (("Camera2", EUROC_CAM2, EUROC_DIST2),) if stereo else ())
    for k, cam, dist in cams:
        lines += [f"{k}.{p}: {cam[p]}" for p in ("fx", "fy", "cx", "cy")]
        lines += [f"{k}.{d}: {v}" for d, v in dist.items()]
    lines += [f"Camera.width: {EUROC_CAM1['width']}", f"Camera.height: {EUROC_CAM1['height']}",
              f"Camera.fps: {EUROC_FPS}", "Camera.RGB: 1", "Stereo.ThDepth: 60.0"]
    if stereo:
        lines += matrix("Stereo.T_c1_c2", EUROC_T_C1_C2)
    lines += matrix("IMU.T_b_c1", EUROC_T_B_C1)
    lines += [f"{k}: {v}" for k, v in EUROC_IMU.items()]
    lines += [f"ORBextractor.nFeatures: {n_features}", "ORBextractor.scaleFactor: 1.2",
              "ORBextractor.nLevels: 8", "ORBextractor.iniThFAST: 20",
              "ORBextractor.minThFAST: 7"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def render_euroc(twc, device, seed: int = SEED):
    """cam0 and cam1 images of the box room through their distortion."""
    from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera

    world = syn.make_box_world(seed, tex_size=512, half=ROOM_HALF, device=device)
    H, W = EUROC_CAM1["height"], EUROC_CAM1["width"]
    out = []
    for cam, dist, T in ((EUROC_CAM1, EUROC_DIST1, None), ({**EUROC_CAM1, **EUROC_CAM2},
                                                           EUROC_DIST2, EUROC_T_C1_C2)):
        pin = [syn.render_image(world, Tw if T is None else compose_pose(Tw, T), cam["fx"],
                                cam["fy"], cam["cx"], cam["cy"], H, W) for Tw in twc]
        geo = PinholeCamera(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"], width=W,
                            height=H, **dist)
        out.append(through_distortion(geo, pin))
    return out


@contextlib.contextmanager
def sync_checked(rec: dict, solvers):
    """Run each ``(module, name)`` function of ``solvers`` under
    ``torch.cuda.set_sync_debug_mode("error")`` for the duration, counting
    its calls in ``rec["sync_free"]``."""
    originals = {(m, n): getattr(m, n) for m, n in solvers}

    def sync_free(fn, name):
        def wrapper(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                rec.setdefault("sync_free", collections.Counter())[name] += 1
        return wrapper

    for (m, n), fn in originals.items():
        setattr(m, n, sync_free(fn, n))
    try:
        yield
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)


@contextlib.contextmanager
def binding_checked(rec: dict, phase: str):
    """``check_binding_consistency`` after every mapping job for the
    duration (a failure ends the script); the jobs counted in ``rec["jobs"]``."""
    orig_job = LocalMapper.process_keyframe

    def job(self, kf_id, *a, **k):
        out = orig_job(self, kf_id, *a, **k)
        issues = map_mod.check_binding_consistency(self.map)
        if issues:
            fail(f"{phase}: bindings inconsistent after the job of keyframe {kf_id}: {issues[:3]}")
        rec["jobs"] = rec.get("jobs", 0) + 1
        return out

    LocalMapper.process_keyframe = job
    try:
        yield
    finally:
        LocalMapper.process_keyframe = orig_job


@contextlib.contextmanager
def spy_inertial(rec: dict):
    """Per frame of an inertial drive: host ms (synchronized), keyframe,
    the map's IMU state; the host ms of every ``_vi_refine``,
    ``local_inertial_bundle_adjustment``, ``full_inertial_ba`` and
    ``maybe_initialize_imu`` (synchronized) and the last ``_vi_refine``'s
    arguments (profiled after the drive, ``profile_inertial``); the three
    solvers run under ``torch.cuda.set_sync_debug_mode("error")``;
    ``check_binding_consistency`` after every mapping job."""
    from orb_slam3_rgbl_tpu_torch.optim import inertial as inertial_mod, inertial_ba

    timed = {"_vi_refine": (Tracker, "vi_refine"),
             "local_inertial_bundle_adjustment": (LocalMapper, "local_viba"),
             "full_inertial_ba": (LocalMapper, "full_viba"),
             "maybe_initialize_imu": (LocalMapper, "imu_init")}
    originals = {n: getattr(c, n) for n, (c, _) in timed.items()}
    solvers = [(inertial_mod, "inertial_pose_optimize_prior"),
               (inertial_mod, "imu_initialization"), (inertial_ba, "vi_bundle_adjust")]
    orig_post = System._post_track

    def timing(key, fn):
        def wrapper(self, *a, **k):
            if key == "vi_refine":
                rec["vi_refine_args"] = a
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            rec.setdefault(key, []).append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    def post(self, res):
        out = orig_post(self, res)
        rec.setdefault("frames", []).append(
            (bool(res.created_kf), bool(self.map.imu_initialized),
             int(self.mapper._viba_stage) if self.mapper is not None else 0))
        return out

    for n, (c, key) in timed.items():
        setattr(c, n, timing(key, originals[n]))
    System._post_track = post
    try:
        with sync_checked(rec, solvers), binding_checked(rec, "phase 13"):
            yield
    finally:
        for n, (c, _) in timed.items():
            setattr(c, n, originals[n])
        System._post_track = orig_post


def _angle_deg(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b)), a @ b)))


def phase13_mode(mode: str, mav: str, ts_file: str, settings: str, twc_gt, vel_gt, g_world,
                 device, workdir: str):
    """One inertial mode of ``run_euroc`` over the written sequence, held to
    its checks; returns its record."""
    from orb_slam3_rgbl_tpu_torch.examples import run_euroc

    n = min(len(twc_gt), EUROC_MODE_FRAMES[mode])
    twc_gt, vel_gt = twc_gt[:n], vel_gt[:n]
    stereo = mode == "stereo-inertial"
    out_tum = os.path.join(workdir, f"{mode}_f.txt")
    argv = [settings, mav, "--mode", mode, "--timestamps", ts_file, "--frames", str(n),
            "--out-tum", out_tum, "--out-kf", os.path.join(workdir, f"{mode}_kf.txt"),
            "--device", device.type]
    rec = {}
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    with spy_inertial(rec):
        slam, results, times = run_euroc.run(run_euroc.parse_args(argv))
        wall = time.perf_counter() - t0
        # VIBA1 on the driven state, unless the drive reached it
        mapper = slam.mapper
        viba1_in_drive = mapper._viba_stage >= 1
        if mapper._imu_init_time is not None and not viba1_in_drive:
            mapper.maybe_viba(mapper._imu_init_time + VIBA1_AFTER_S)
            issues = map_mod.check_binding_consistency(slam.map)
            if issues:
                fail(f"phase 13 {mode}: bindings inconsistent after VIBA1: {issues[:3]}")
    counts = dict(cuda_build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    frames = rec["frames"]
    states = [r.state for r in results]
    init = next((i for i, f in enumerate(frames) if f[1]), None)
    if init is None:
        fail(f"phase 13 {mode}: the IMU never initialized over {n} frames")
    first_ok = states.index(trk.OK)
    viba1 = (f"on frame {next(i for i, f in enumerate(frames) if f[2] >= 1)}" if viba1_in_drive
             else f"by maybe_viba at the initialization's time + {VIBA1_AFTER_S:.0f} s, "
                  f"{results[-1].timestamp - mapper._imu_init_time:.2f} s after it the drive's "
                  f"last frame")
    per = 2 if stereo else 1
    # after the IMU initialization every frame OK, or RECENTLY_LOST on the
    # IMU's prediction inside the grace window (time_recently_lost after the
    # last OK frame); never LOST
    last_ok, grace = results[init].timestamp, slam.tracker.time_recently_lost
    dead_reckoned = []
    for i in range(init, n):
        if states[i] == trk.OK:
            last_ok = results[i].timestamp
        elif states[i] == trk.RECENTLY_LOST and results[i].timestamp - last_ok <= grace:
            dead_reckoned.append(i)
        else:
            fail(f"phase 13 {mode}: frame {i} {trk.STATE_NAMES[states[i]]} after the IMU "
                 f"initialization: {[trk.STATE_NAMES[s] for s in states[init:]]}")
    if init - first_ok > IMU_INIT_BY[mode]:
        fail(f"phase 13 {mode}: IMU initialized {init - first_ok} frames after the first OK frame "
             f"{first_ok} (bound {IMU_INIT_BY[mode]})")
    if mapper._viba_stage < 1 or len(rec.get("full_viba", [])) != 1:
        fail(f"phase 13 {mode}: VIBA1 did not run ({n} frames, init on frame {init}, VIBA stage "
             f"{mapper._viba_stage}, {len(rec.get('full_viba', []))} full inertial BAs)")
    if counts.get("fast_and_blur") != per * n or counts.get("brief_continuous") != per * n:
        fail(f"phase 13 {mode}: launch counts {counts} over {n} frames; expected {per} K1 and "
             f"{per} K2 a frame")
    for name in ("imu_initialization", "vi_bundle_adjust") + (
            ("inertial_pose_optimize_prior",)):
        if not rec.get("sync_free", {}).get(name):
            fail(f"phase 13 {mode}: {name} never ran under set_sync_debug_mode('error')")
    # accuracy: the System's world against the ground truth
    est = slam.trajectory()
    if est.shape != (n, 7) or not np.isfinite(est).all():
        fail(f"phase 13 {mode}: trajectory() gave {est.shape}")
    sel = np.arange(init, n)
    gt_c = twc_gt[:, 4:7]
    a = align.horn_align(torch.as_tensor(est[sel, 4:7]), torch.as_tensor(gt_c[sel]))
    ate = float(a.rmse)
    a_s = align.horn_align(torch.as_tensor(est[sel, 4:7]), torch.as_tensor(gt_c[sel]),
                           with_scale=True)
    scale_err = abs(float(a_s.s) - 1.0)
    # gravity in the camera frame, estimated (the world's −z) against true
    R_rect = slam.rectifier.R1 if slam.rectifier is not None else np.eye(3)
    g_errs = []
    for i in sel:
        conj = np.array([1, -1, -1, -1], np.float32)
        g_c_true = R_rect @ lie.np_quat_rotate(twc_gt[i, :4] * conj, g_world.astype(np.float32))
        g_c_est = lie.np_quat_rotate(est[i, :4] * conj, np.array([0, 0, -9.81], np.float32))
        g_errs.append(_angle_deg(g_c_true, g_c_est))
    g_err = float(np.median(g_errs))
    # the last keyframe's velocity against the body's
    m = slam.map
    k_last = int(m.valid_kf_ids()[-1])
    fi = int(np.argmin(np.abs(np.asarray([r.timestamp for r in results]) - m.kf_timestamp[k_last])))
    v_err = abs(np.linalg.norm(m.kf_vel[k_last]) - np.linalg.norm(vel_gt[fi])) / np.linalg.norm(
        vel_gt[fi])
    if not g_err < MAX_GRAVITY_ERR_DEG:
        fail(f"phase 13 {mode}: gravity direction off by {g_err:.2f} deg (bound "
             f"{MAX_GRAVITY_ERR_DEG})")
    if not ate < MAX_ATE_M[mode]:
        fail(f"phase 13 {mode}: SE3-aligned ATE {ate:.4f} m after init (bound {MAX_ATE_M[mode]})")
    if not v_err < MAX_VEL_ERR:
        fail(f"phase 13 {mode}: last keyframe's speed off by {v_err:.3f} (bound {MAX_VEL_ERR})")
    if mode == "mono-inertial" and not scale_err < MAX_SCALE_ERR:
        fail(f"phase 13 {mode}: scale {float(a_s.s):.4f} against the ground truth (bound "
             f"{MAX_SCALE_ERR} from 1)")
    ms = np.asarray(times) * 1e3
    kinds = {"before init": [i for i in range(1, init)],
             "after init, no keyframe": [i for i in range(init + 1, n) if not frames[i][0]],
             "keyframe (its synchronous job)": [i for i in range(init + 1, n) if frames[i][0]]}
    for kind, idx in kinds.items():
        log(f"phase 13 {mode}: host ms/frame, {kind}: {_median_p90([ms[i] for i in idx])}")
    log(f"phase 13 {mode}: first OK frame {first_ok}; frames dead-reckoned in RECENTLY_LOST "
        f"after init {dead_reckoned}; IMU initialized on frame {init} "
        f"({ms[init]:.1f} ms host, its frame); VIBA1 {viba1}; "
        f"VIBA stage at the end {mapper._viba_stage}; {m.n_kf} keyframes ({len(m.valid_kf_ids())} "
        f"live), {rec.get('jobs', 0)} mapping jobs, {int(m.lm_valid.sum())} landmarks; "
        f"counts {dict(slam.mapper.counts)}")
    log(f"phase 13 {mode}: maybe_initialize_imu: {len(rec.get('imu_init', []))} calls, the one "
        f"that ran the solve {max(rec.get('imu_init', [0.0])):.1f} ms host")
    for key, what in (("vi_refine", "_vi_refine"), ("local_viba", "local_inertial_bundle_adjustment"),
                      ("full_viba", "full_inertial_ba (VIBA1's first)")):
        log(f"phase 13 {mode}: {what}: host ms {_median_p90(rec.get(key, []))}")
    log(f"phase 13 {mode}: gravity direction error after init median {g_err:.3f} deg; "
        f"SE3-aligned ATE after init {ate:.4f} m (bound {MAX_ATE_M[mode]}); Sim3 scale "
        f"{float(a_s.s):.4f} against the ground truth; last keyframe's speed "
        f"{np.linalg.norm(m.kf_vel[k_last]):.3f} m/s against {np.linalg.norm(vel_gt[fi]):.3f} "
        f"({v_err:.3f} relative); launches {counts} ({per} K1 + {per} K2 a frame); solvers "
        f"sync-free {dict(rec.get('sync_free', {}))}; peak memory {peak:.0f} MiB; "
        f"driver wall {wall:.1f} s")
    return slam, rec


def profile_inertial(slam, rec: dict, mode: str):
    """One call each of the inertial solves on the drive's final state,
    under the profiler, with the card to themselves: the last frame's
    ``_vi_refine`` again, a ``local_inertial_bundle_adjustment`` and a
    ``full_inertial_ba`` (VIBA's solve) ending at the last keyframe."""
    kf = int(slam.map.valid_kf_ids()[-1])
    calls = (("_vi_refine (the last frame's)", lambda: slam.tracker._vi_refine(
                *rec["vi_refine_args"])),
             ("local_inertial_bundle_adjustment", lambda: slam.mapper.local_inertial_bundle_adjustment(kf)),
             ("full_inertial_ba over the whole chain", lambda: slam.mapper.full_inertial_ba(kf)))
    for what, fn in calls:
        torch.cuda.synchronize()
        with _profile(cpu=False) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        dev = _device_work(prof.events())
        busy = _busy_ms(dev)
        if not dev:
            text = "no device events recorded (device busy time not measured)"
        elif busy > ms:
            text = (f"{len(dev)} device events whose union, {busy:.3f} ms, exceeds the host time "
                    f"(device busy time not measured)")
        else:
            text = (f"{busy:.3f} ms device busy (the union of {len(dev)} kernels' intervals, "
                    f"{100 * busy / ms:.1f}% of the host time)")
        log(f"phase 13 {mode}: {what} under the profiler (device activity only): {ms:.1f} ms "
            f"host, {text}")


EUROC_MODES = {"stereo-inertial": 1200, "mono-inertial": 1000}   # mode: ORB features


def phase13_files(workdir: str, mode: str):
    """(mav dir, timestamps file, settings file) of a written sequence."""
    return (os.path.join(workdir, "mav0"), os.path.join(workdir, "timestamps.txt"),
            os.path.join(workdir, f"{mode}.yaml"))


def phase13(device, card: str, modes=tuple(EUROC_MODES)):
    """The inertial sensors: a EuRoC-shaped sequence (752×480 distorted
    stereo, 200 Hz IMU, 20 fps) written to disk and run through
    ``run_euroc`` in the inertial ``modes``, one after the other. With the
    stereo-inertial mode, K1 and K2 are held to their plain versions at
    752×480 first and the drive's solves are profiled after it."""
    t0 = time.perf_counter()
    log(f"phase 13 ({', '.join(modes)}) on {card}")
    if "stereo-inertial" in modes:
        k_cfg = dataclasses.replace(
            kitti_synthetic_config(),
            camera=dataclasses.replace(kitti_synthetic_config().camera, **EUROC_CAM1),
            orb=dataclasses.replace(kitti_synthetic_config().orb, n_features=1200))
        # phase 13 leads its process, where the profiler still records K1's
        # device time
        phase1_kernels(k_cfg, device)
    times, twc, vel, imu_rows, g_world = euroc_motion(N_EUROC)
    lefts, rights = render_euroc(twc, device)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_euroc_")
    try:
        t1 = time.perf_counter()
        mav, ts_file = write_euroc(workdir, times, lefts, rights, imu_rows)
        log(f"phase 13: wrote {N_EUROC} stereo pairs at {EUROC_CAM1['width']}x"
            f"{EUROC_CAM1['height']} and {len(imu_rows)} IMU samples at {IMU_HZ} Hz in "
            f"{time.perf_counter() - t1:.1f} s (render and motion {t1 - t0:.1f} s)")
        del lefts, rights
        np.savez(os.path.join(workdir, "gt.npz"), twc=twc, vel=vel, g=g_world)
        for mode, nf in EUROC_MODES.items():
            euroc_settings_yaml(phase13_files(workdir, mode)[2], nf,
                                stereo=mode == "stereo-inertial")
        for mode in modes:
            t1 = time.perf_counter()
            slam, rec = phase13_mode(mode, *phase13_files(workdir, mode), twc, vel, g_world,
                                     device, workdir)
            t2 = time.perf_counter()
            if mode == "stereo-inertial":
                profile_inertial(slam, rec, mode)
            log(f"phase 13: the {mode} drive {t2 - t1:.1f} s"
                + (f", its three profiled calls {time.perf_counter() - t2:.1f} s (the traces' "
                   f"processing included)" if mode == "stereo-inertial" else ""))
            del slam, rec
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s on {card}")



# ---- phase 14: the KannalaBrandt8 fisheye pair on a TUM-VI-shaped sequence ----
# the TUM-VI-like fisheye of tests/test_fisheye_e2e.py (cam0) and of
# tests/test_kb8_stereo.py's right camera (cam1); KB8's k0..k3 are the
# settings' Camera1.k1..k4
TUMVI_CAM1 = dict(fx=190.978, fy=190.973, cx=254.932, cy=256.897)
TUMVI_KB8_1 = dict(k1=0.00348, k2=0.000715, k3=-0.0020532, k4=0.000202)
TUMVI_CAM2 = dict(fx=190.44, fy=190.44, cx=252.07, cy=254.95)
TUMVI_KB8_2 = dict(k1=0.0034, k2=0.0008, k3=-0.0021, k4=0.0002)
TUMVI_SIZE = 512
TUMVI_BASELINE = 0.101
TUMVI_RIGHT_TURN_DEG = 0.5    # cam1 turned about its y axis: an unrectified pair
TUMVI_FEATURES = 1000
# the IMU noise of the reference's Examples/Stereo-Inertial/TUM-VI.yaml;
# the body <- camera extrinsic is phase 13's (euroc_motion builds the IMU
# samples through it)
TUMVI_IMU = {"IMU.NoiseGyro": 0.00016, "IMU.NoiseAcc": 0.0028, "IMU.GyroWalk": 0.000022,
             "IMU.AccWalk": 0.00086, "IMU.Frequency": 200.0}
# an indoor room: over the 0.101 m baseline the triangulation's parallax
# gate (cos < 0.9998, 1.15 deg) passes points closer than ~5 m
TUMVI_ROOM_HALF = 2.5
TUMVI_START = np.array([0.0, 0.0, -1.2])   # cam0's first position in the room
N_TUMVI = 40                  # frames written (2 s at 20 fps)
# frames each mode drives: the stereo pair all 40; stereo-inertial ends a
# few frames after its IMU initialization (a frame after it costs ~2 s of
# host time, phase 13)
TUMVI_MODE_FRAMES = {"stereo": 40, "stereo-inertial": 30}
# bounds from both packages' CPU rehearsals at this size
# (tests/rehearse_phase14.py, PERF.md section 6): the IMU initialized on
# frame 25 in both (the first OK frame 0); SE3-aligned ATE, ~3x the worse of
# the two: stereo 0.0795 (port) and 0.0801 m (JAX) over the 40 frames,
# stereo-inertial 0.0109 and 0.0113 m after the initialization
TUMVI_IMU_INIT_BY = 25        # frames after the first OK frame
TUMVI_MAX_ATE_M = {"stereo": 0.24, "stereo-inertial": 0.034}
OFF_AXIS_DEG = 30.0           # test_fisheye_e2e's off-axis landmarks
MIN_OFF_AXIS = 20
MAX_OFF_AXIS_MEDIAN_PX = 2.0


def tumvi_cameras():
    """(cam0, cam1) as KannalaBrandt8Camera."""
    from orb_slam3_rgbl_tpu_torch.geometry.camera import KannalaBrandt8Camera

    return tuple(KannalaBrandt8Camera(**cam, k0=kb["k1"], k1=kb["k2"], k2=kb["k3"], k3=kb["k4"],
                                      width=TUMVI_SIZE, height=TUMVI_SIZE)
                 for cam, kb in ((TUMVI_CAM1, TUMVI_KB8_1), (TUMVI_CAM2, TUMVI_KB8_2)))


def tumvi_T_c1_c2() -> np.ndarray:
    a = np.deg2rad(TUMVI_RIGHT_TURN_DEG)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[0, 3] = TUMVI_BASELINE
    return T


def render_kb8(world, Twc, cam, ss: int = 2) -> torch.Tensor:
    """(H, W) view of ``world`` from camera pose Twc (7,) through the
    KannalaBrandt8 camera ``cam``, supersampled ``ss``x per axis: each
    subpixel's ray is ``kb8_unproject``'s z = 1 bearing, turned back where
    the subpixel sees past 90 deg (there tan(theta) < 0 mirrors the bearing),
    cast through the synthetic world's planes and shaded by its textures."""
    from orb_slam3_rgbl_tpu_torch.geometry import camera as cam_mod

    dev = world.tex.device
    Twc = torch.as_tensor(np.asarray(Twc, np.float32), device=dev)
    H, W = cam.height, cam.width
    ys = (torch.arange(H * ss, dtype=torch.float32, device=dev) + 0.5) / ss
    xs = (torch.arange(W * ss, dtype=torch.float32, device=dev) + 0.5) / ss
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    rays = cam_mod.kb8_unproject(cam, torch.stack([u, v], dim=-1))
    t2 = (np.pi / 2) ** 2
    d90 = np.pi / 2 * (1 + t2 * (cam.k0 + t2 * (cam.k1 + t2 * (cam.k2 + t2 * cam.k3))))
    past = torch.hypot((u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy) > d90
    rays = torch.where(past[..., None], -rays, rays)
    d_w = torch.einsum("ij,hwj->hwi", lie.quat_to_matrix(Twc[:4]), rays)
    o = Twc[4:7].expand(d_w.shape)
    t, plane, hit = syn._cast(world, o, d_w)
    img = torch.where(hit, syn._shade(world, o + torch.where(hit, t, 0.0)[..., None] * d_w,
                                      plane), 0.0)
    if ss > 1:
        img = img.reshape(H, ss, W, ss).mean(dim=(1, 3))
    return img.contiguous()


def render_tumvi(twc, device, seed: int = SEED):
    """cam0 and cam1 images of the room through the fisheye pair."""
    world = syn.make_box_world(seed, tex_size=512, half=TUMVI_ROOM_HALF, device=device)
    cam0, cam1 = tumvi_cameras()
    T12 = tumvi_T_c1_c2()
    return ([render_kb8(world, Tw, cam0) for Tw in twc],
            [render_kb8(world, compose_pose(Tw, T12), cam1) for Tw in twc])


def tumvi_settings_yaml(path: str):
    """A KannalaBrandt8 settings file in the reference's format
    (``File.version: "1.0"``, ``Camera.type: "KannalaBrandt8"``, ``Camera1``
    and ``Camera2`` with k1..k4, ``Stereo.T_c1_c2``, ``IMU.T_b_c1``)."""
    def matrix(name, M):
        return [f"{name}: !!opencv-matrix", "  rows: 4", "  cols: 4", "  dt: f",
                "  data: [" + ", ".join(repr(float(v)) for v in M.reshape(-1)) + "]"]

    lines = ["%YAML:1.0", 'File.version: "1.0"', 'Camera.type: "KannalaBrandt8"']
    for k, cam, kb in (("Camera1", TUMVI_CAM1, TUMVI_KB8_1), ("Camera2", TUMVI_CAM2, TUMVI_KB8_2)):
        lines += [f"{k}.{p}: {v}" for p, v in {**cam, **kb}.items()]
    lines += [f"Camera.width: {TUMVI_SIZE}", f"Camera.height: {TUMVI_SIZE}",
              f"Camera.fps: {EUROC_FPS}", "Camera.RGB: 1", "Stereo.ThDepth: 40.0"]
    lines += matrix("Stereo.T_c1_c2", tumvi_T_c1_c2())
    lines += matrix("IMU.T_b_c1", EUROC_T_B_C1)
    lines += [f"{k}: {v}" for k, v in TUMVI_IMU.items()]
    lines += [f"ORBextractor.nFeatures: {TUMVI_FEATURES}", "ORBextractor.scaleFactor: 1.2",
              "ORBextractor.nLevels: 8", "ORBextractor.iniThFAST: 20",
              "ORBextractor.minThFAST: 7"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def tumvi_motion(n_frames: int):
    """Phase 13's hand-held motion and IMU, moved into the fisheye room:
    cam0 starts at ``TUMVI_START`` (the IMU samples do not change)."""
    times, twc, vel, imu_rows, g_world = euroc_motion(n_frames)
    twc = twc.copy()
    twc[:, 4:7] += (TUMVI_START - twc[0, 4:7]).astype(np.float32)
    return times, twc, vel, imu_rows, g_world


@contextlib.contextmanager
def spy_fisheye(rec: dict):
    """Per frame of a fisheye drive: host ms is the driver's; here the
    frame's keyframe and IMU state; per ``attach_stereo_fisheye_depth``:
    host ms (synchronized), valid left keypoints and those with a fisheye
    depth, and the last call's arguments; ``check_binding_consistency``
    after every mapping job; the KB8 pose solve, local BA and inertial
    solves under ``torch.cuda.set_sync_debug_mode("error")``."""
    from orb_slam3_rgbl_tpu_torch.optim import inertial as inertial_mod, inertial_ba
    from orb_slam3_rgbl_tpu_torch.optim import pose_opt

    solvers = [(pose_opt, "pose_optimize"), (local_ba, "bundle_adjust"),
               (inertial_mod, "inertial_pose_optimize"),
               (inertial_mod, "inertial_pose_optimize_prior"),
               (inertial_mod, "imu_initialization"), (inertial_ba, "vi_bundle_adjust")]
    orig_attach = frame_mod.attach_stereo_fisheye_depth
    orig_post = System._post_track

    def attach(feats_l, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_attach(feats_l, *a, **k)
        torch.cuda.synchronize()
        rec.setdefault("attach_ms", []).append((time.perf_counter() - t) * 1e3)
        rec.setdefault("depth_share", []).append(
            float((out.depth > 0).sum()) / max(int(feats_l.valid.sum()), 1))
        rec["attach_args"] = (feats_l,) + a, k
        return out

    def post(self, res):
        out = orig_post(self, res)
        rec.setdefault("frames", []).append((bool(res.created_kf), bool(self.map.imu_initialized)))
        return out

    frame_mod.attach_stereo_fisheye_depth = attach
    System._post_track = post
    try:
        with sync_checked(rec, solvers), binding_checked(rec, "phase 14"):
            yield
    finally:
        frame_mod.attach_stereo_fisheye_depth = orig_attach
        System._post_track = orig_post


def off_axis_reprojection(slam):
    """(count, median px): landmarks more than ``OFF_AXIS_DEG`` off the
    optical axis of the last keyframe and bound there, reprojected through
    the KB8 model against their keypoints (test_fisheye_e2e's check)."""
    from orb_slam3_rgbl_tpu_torch.geometry.camera import np_geo_project

    m = slam.map
    kf = int(m.valid_kf_ids()[-1])
    row = m.kf_lm_idx[kf]
    feat = np.nonzero(row >= 0)[0]
    pc = lie.np_se3_apply(m.kf_pose[kf], m.lm_pos[row[feat]])
    theta = np.degrees(np.arctan2(np.linalg.norm(pc[:, :2], axis=1), pc[:, 2]))
    off = theta > OFF_AXIS_DEG
    errs = np.linalg.norm(np_geo_project(slam.tracker.geo_cam, pc[off]) - m.kf_uv[kf, feat[off]],
                          axis=1)
    return int(off.sum()), float(np.median(errs)) if off.any() else float("inf")


def phase14_mode(mode: str, mav: str, ts_file: str, settings: str, twc_gt, device,
                 workdir: str):
    """One mode of ``run_euroc`` over the fisheye sequence, held to its
    checks; returns its record."""
    from orb_slam3_rgbl_tpu_torch.examples import run_euroc
    from orb_slam3_rgbl_tpu_torch.geometry.camera import is_fisheye

    n = min(len(twc_gt), TUMVI_MODE_FRAMES[mode])
    twc_gt = twc_gt[:n]
    argv = [settings, mav, "--mode", mode, "--timestamps", ts_file, "--frames", str(n),
            "--out-tum", os.path.join(workdir, f"{mode}_f.txt"),
            "--out-kf", os.path.join(workdir, f"{mode}_kf.txt"), "--device", device.type]
    rec = {}
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    with spy_fisheye(rec):
        slam, results, times = run_euroc.run(run_euroc.parse_args(argv))
    wall = time.perf_counter() - t0
    counts = dict(cuda_build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if not (is_fisheye(slam.tracker.geo_cam) and is_fisheye(slam.mapper.geo_cam)
            and slam.rectifier is None):
        fail(f"phase 14 {mode}: the System did not take the KB8 camera unrectified")
    frames = rec["frames"]
    states = [r.state for r in results]
    inliers = [r.n_inliers for r in results]
    first_ok = states.index(trk.OK) if trk.OK in states else None
    if first_ok is None:
        fail(f"phase 14 {mode}: no frame OK: {[trk.STATE_NAMES[s] for s in states]}")
    init = next((i for i, f in enumerate(frames) if f[1]), None)
    if mode == "stereo":
        bad = [i for i in range(1, n) if states[i] != trk.OK or inliers[i] < MIN_INLIERS]
        if states[0] != trk.OK or bad:
            fail(f"phase 14 stereo: frames {bad} not OK with >= {MIN_INLIERS} inliers: states "
                 f"{[trk.STATE_NAMES[s] for s in states]}, inliers {inliers}")
        sel = np.arange(n)
    else:
        if init is None:
            fail(f"phase 14 {mode}: the IMU never initialized over {n} frames")
        if init - first_ok > TUMVI_IMU_INIT_BY:
            fail(f"phase 14 {mode}: IMU initialized {init - first_ok} frames after the first OK "
                 f"frame {first_ok} (bound {TUMVI_IMU_INIT_BY})")
        bad = [i for i in range(first_ok, n) if states[i] != trk.OK]
        if bad:
            fail(f"phase 14 {mode}: frames {bad} not OK: {[trk.STATE_NAMES[s] for s in states]}")
        sel = np.arange(init, n)
    if counts.get("fast_and_blur") != 2 * n or counts.get("brief_continuous") != 2 * n:
        fail(f"phase 14 {mode}: launch counts {counts} over {n} frames; expected 2 K1 and 2 K2 a "
             f"frame")
    if len(rec.get("attach_ms", [])) != n:
        fail(f"phase 14 {mode}: attach_stereo_fisheye_depth ran {len(rec.get('attach_ms', []))} "
             f"times over {n} frames")
    need = ["pose_optimize", "bundle_adjust"] + (
        ["imu_initialization", "inertial_pose_optimize_prior"] if mode != "stereo" else [])
    for name in need:
        if not rec.get("sync_free", {}).get(name):
            fail(f"phase 14 {mode}: {name} never ran under set_sync_debug_mode('error')")
    n_off, med_off = off_axis_reprojection(slam)
    if n_off <= MIN_OFF_AXIS or not med_off < MAX_OFF_AXIS_MEDIAN_PX:
        fail(f"phase 14 {mode}: {n_off} landmarks over {OFF_AXIS_DEG:.0f} deg off the axis bound "
             f"in the last keyframe (need > {MIN_OFF_AXIS}), KB8 reprojection median {med_off:.3f} "
             f"px (bound {MAX_OFF_AXIS_MEDIAN_PX})")
    est = slam.trajectory()
    if est.shape != (n, 7) or not np.isfinite(est).all():
        fail(f"phase 14 {mode}: trajectory() gave {est.shape}")
    a = align.horn_align(torch.as_tensor(est[sel, 4:7]), torch.as_tensor(twc_gt[sel, 4:7]))
    ate = float(a.rmse)
    if not ate < TUMVI_MAX_ATE_M[mode]:
        fail(f"phase 14 {mode}: SE3-aligned ATE {ate:.4f} m (bound {TUMVI_MAX_ATE_M[mode]})")
    ms = np.asarray(times) * 1e3
    kf = [f[0] for f in frames]
    first = 1 if init is None else init + 1
    kinds = {"no keyframe": [i for i in range(first, n) if not kf[i]],
             "keyframe (its synchronous job)": [i for i in range(first, n) if kf[i]]}
    if init is not None:
        kinds = {"before the IMU initialization": list(range(1, init)), **{
            f"after it, {k}": v for k, v in kinds.items()}}
    for kind, idx in kinds.items():
        if idx:
            log(f"phase 14 {mode}: host ms/frame, {kind}: {_median_p90([ms[i] for i in idx])}")
    share = np.asarray(rec["depth_share"])
    log(f"phase 14 {mode}: {n} frames, first OK {first_ok}"
        + (f", IMU initialized on frame {init} ({ms[init]:.1f} ms host, its frame)"
           if init is not None else "")
        + f"; inliers min {min(inliers[1:])} median {int(np.median(inliers[1:]))}; "
        f"{slam.map.n_kf} keyframes ({len(slam.map.valid_kf_ids())} live), {rec.get('jobs', 0)} "
        f"mapping jobs (bindings consistent after each), {int(slam.map.lm_valid.sum())} "
        f"landmarks; launches {counts} (2 K1 + 2 K2 a frame); valid left keypoints with a "
        f"fisheye depth {share.mean():.4f} mean ({share.min():.4f}-{share.max():.4f}); "
        f"attach_stereo_fisheye_depth host ms {_median_p90(rec['attach_ms'])}; {n_off} "
        f"landmarks > {OFF_AXIS_DEG:.0f} deg off the axis bound in the last keyframe, KB8 "
        f"reprojection median {med_off:.3f} px; SE3-aligned ATE {ate:.4f} m (bound "
        f"{TUMVI_MAX_ATE_M[mode]}); solvers sync-free {dict(rec.get('sync_free', {}))}; peak "
        f"memory {peak:.0f} MiB; driver wall {wall:.1f} s")
    return slam, rec


def phase14(device, card: str):
    """The KannalaBrandt8 fisheye pair: K1 and K2 held to their plain
    versions at 512x512, then a TUM-VI-shaped sequence (512x512 unrectified
    fisheye stereo at 20 fps, 200 Hz IMU) written to disk and run through
    ``run_euroc --mode stereo`` and ``--mode stereo-inertial``."""
    t0 = time.perf_counter()
    log(f"phase 14 on {card}")
    times, twc, _, imu_rows, _ = tumvi_motion(N_TUMVI)
    lefts, rights = render_tumvi(twc, device)
    base = kitti_synthetic_config()
    k_cfg = dataclasses.replace(
        base, camera=dataclasses.replace(base.camera, **TUMVI_CAM1, width=TUMVI_SIZE,
                                         height=TUMVI_SIZE),
        orb=dataclasses.replace(base.orb, n_features=TUMVI_FEATURES))
    # device times only when the phase runs alone (`--phase14`), as phase 13:
    # after phase 13 in the same process the profiler records none for K1
    k = phase1_kernels(k_cfg, device, device_times=sys.argv[1:] == ["--phase14"],
                       image=lefts[0])
    log(f"phase 14: K1 {k['fast_and_blur']['ms']:.4f} ms (events), "
        f"{k['fast_and_blur']['device_ms']:.4f} ms (device), bound "
        f"{k['fast_and_blur']['bound'][0] * 1e3:.3f} us ({k['fast_and_blur']['bound'][1]}); "
        f"K2 {k['brief_continuous']['ms']:.4f} ms (events), "
        f"{k['brief_continuous']['device_ms']:.4f} ms (device), bound "
        f"{k['brief_continuous']['bound'][0] * 1e3:.3f} us ({k['brief_continuous']['bound'][1]}) "
        f"at {TUMVI_SIZE}x{TUMVI_SIZE}, {TUMVI_FEATURES} features")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tumvi_")
    try:
        t1 = time.perf_counter()
        mav, ts_file = write_euroc(workdir, times, lefts, rights, imu_rows)
        del lefts, rights
        settings = os.path.join(workdir, "tumvi.yaml")
        tumvi_settings_yaml(settings)
        log(f"phase 14: wrote {N_TUMVI} fisheye pairs at {TUMVI_SIZE}x{TUMVI_SIZE} and "
            f"{len(imu_rows)} IMU samples in {time.perf_counter() - t1:.1f} s (render and the "
            f"kernel checks {t1 - t0:.1f} s)")
        t1 = time.perf_counter()
        slam, rec = phase14_mode("stereo", mav, ts_file, settings, twc, device, workdir)
        args, kwargs = rec["attach_args"]
        dev_ms, kernels = profile_call(lambda: frame_mod.attach_stereo_fisheye_depth(*args,
                                                                                    **kwargs))
        with _profile() as prof:
            frame_mod.attach_stereo_fisheye_depth(*args, **kwargs)
            torch.cuda.synchronize()
        by_name = collections.Counter(e.name[:60] for e in prof.events() if _on_device(e))
        n_l, n_r = args[0].uv.shape[0], args[1].uv.shape[0]
        log(f"phase 14: attach_stereo_fisheye_depth ({n_l} x {n_r} Hamming table, the last "
            f"frame's features): {dev_ms:.4f} ms device in {kernels:.0f} kernels; the most "
            f"launched: " + "; ".join(f"{n} x {k}" for k, n in by_name.most_common(6)))
        del slam, rec
        t2 = time.perf_counter()
        phase14_mode("stereo-inertial", mav, ts_file, settings, twc, device, workdir)
        log(f"phase 14: the stereo drive {t2 - t1:.1f} s (with the profiled call), the "
            f"stereo-inertial drive {time.perf_counter() - t2:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s on {card}")


# ---- phase 15: the users' host-side surface --------------------------------
N_TOOLS = 41                  # frames of phase 15's sequence (phase 2's canyon)
NODE_MAX_QUEUE = 4            # OnlineSlamNode's default queue: a live node drops its oldest
VOCAB_K, VOCAB_DEPTH = 8, 3   # phase 8's tree
MAX_NODE_DRIFT_M = 5e-3       # the node's poses against the driver's (the CPU tests' 5 mm)


@contextlib.contextmanager
def spy_kernel_streams(rec: list):
    """Record (thread, CUDA stream) of every K1 and K2 launch."""
    getters = {frontend_cuda: frontend_cuda._kernel, brief_cuda: brief_cuda._kernel}

    def wrap(get):
        def getter():
            fn = get()

            def launch(*a):
                rec.append((threading.get_ident(), a[-1]))
                return fn(*a)
            return launch
        return getter

    for mod, get in getters.items():
        mod._kernel = wrap(get)
    try:
        yield
    finally:
        for mod, get in getters.items():
            mod._kernel = get


def _ms_stats(xs) -> str:
    xs = np.asarray(xs, np.float64)
    return f"median {np.median(xs):.2f} mean {xs.mean():.2f}"


def phase15_loader(seq: str, settings: str, workdir: str, traj, expect, device):
    """(a) ``NativeKittiSequence`` against ``KittiSequence`` on every frame,
    then the RGB-L driver, which loads through it: the images it gives the
    System equal to the PNGs' (``check_run``)."""
    from orb_slam3_rgbl_tpu_torch.examples import run_kitti_rgbl
    from orb_slam3_rgbl_tpu_torch.io.kitti import KittiSequence
    from orb_slam3_rgbl_tpu_torch.io.native_loader import NativeKittiSequence

    t0 = time.perf_counter()
    loader, plain = NativeKittiSequence(seq), KittiSequence(seq)
    workers = list(loader._workers)
    n = len(plain)
    decode_ms = []
    for i in range(n):
        got = loader.next_frame()
        t1 = time.perf_counter()
        want = plain.frame(i)
        decode_ms.append((time.perf_counter() - t1) * 1e3)
        if not (all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got[:3], want[:3]))
                and got[3] == want[3]):
            fail(f"phase 15: NativeKittiSequence frame {i} differs from KittiSequence.frame({i})")
    if loader.next_frame() is not None:
        fail("phase 15: NativeKittiSequence gave a frame past the sequence's end")
    loader.close()
    alive = [w.pid for w in workers if w.poll() is None]
    if alive:
        fail(f"phase 15: loader workers {alive} alive after close()")
    log(f"phase 15 (a): NativeKittiSequence equal to KittiSequence.frame(i) bit for bit on all "
        f"{n} frames ({len(workers)} worker processes, all ended after close()); "
        f"KittiSequence.frame(i) in this process (PNG decode and cloud) ms/frame "
        f"{_ms_stats(decode_ms)}; both loaders side by side {time.perf_counter() - t0:.1f} s")

    out = os.path.join(workdir, "rgbl.txt")
    slam, results, times, rec, counts = run_driver(
        run_kitti_rgbl, [settings, seq, "--out", out], device)
    errs, _ = check_run("RGB-L driver", results, rec, counts, expect, traj, 0, 2)
    load_ms = np.asarray(slam.timer.samples["load"]) * 1e3
    track_ms = np.asarray(times) * 1e3
    log(f"phase 15 (a): the RGB-L driver: {n} frames, all OK, fused from frame 2, the images "
        f"given to the System equal to the PNGs', {slam.map.n_kf} keyframes, launches {counts}, "
        f"max trans err {errs.max():.3f} m; loop wall ms/frame (load + track) "
        f"{_ms_stats(load_ms + track_ms)}; tracking ms/frame {_ms_stats(track_ms)}; the wait in "
        f"next_frame() ms/frame {_ms_stats(load_ms)} (frame 0: {load_ms[0]:.2f}; after it: "
        f"{_ms_stats(load_ms[1:])})")
    return slam, results, out


def phase15_node(seq: str, settings: str, driver_results, device):
    """(b) The online node fed by the publisher: every frame at full speed
    into a queue that holds them all (held to the driver's poses), then at
    KITTI's real time into the default queue."""
    from orb_slam3_rgbl_tpu_torch.config import RGBL, load_config
    from orb_slam3_rgbl_tpu_torch.io.online import OnlineSlamNode
    from orb_slam3_rgbl_tpu_torch.tools.kitti_publisher import publish

    n = len(driver_results)
    cuda = device.type == "cuda"
    # the node's worker tracks on a stream of its own, not the default: the
    # extraction kernels must launch there, and an asynchronous System must
    # take it as its tracking stream
    worker_stream = torch.cuda.Stream(device) if cuda else None

    class Node(OnlineSlamNode):
        def _run(self):
            if not cuda:
                return super()._run()
            worker_stream.wait_stream(torch.cuda.default_stream(device))
            with torch.cuda.stream(worker_stream):
                super()._run()
            worker_stream.synchronize()

    sysm = System(load_config(settings, sensor=RGBL), device=device)
    poses, streams, launches = [], [], []
    t0 = time.perf_counter()

    def on_pose(t, res):
        poses.append((t, res))
        if cuda:
            streams.append((threading.get_ident(), torch.cuda.current_stream(device).cuda_stream))

    node = Node(sysm, mode="rgbl", on_pose=on_pose, max_queue=n + 1)
    cuda_build.reset_launch_counts()
    with spy_kernel_streams(launches):
        published = publish(seq, node, rate=0.0, log=log)
        node.stop()
    counts = dict(cuda_build.launch_counts)
    sysm.shutdown()
    if len(poses) != n or published != n or node.dropped_frames != 0:
        fail(f"phase 15 (b): published {published}, tracked {len(poses)}, dropped "
             f"{node.dropped_frames}; expected all {n} tracked")
    if any(r.state != trk.OK for _, r in poses):
        fail(f"phase 15 (b): node states {[trk.STATE_NAMES[r.state] for _, r in poses]}")
    if counts.get("fast_and_blur") != n or counts.get("brief_continuous") != n:
        fail(f"phase 15 (b): launch counts {counts} over {n} frames; expected 1 K1 + 1 K2 a frame")
    d = np.linalg.norm(np.stack([lie.np_se3_centers(a.pose) - lie.np_se3_centers(b.pose)
                                 for (_, a), b in zip(poses, driver_results)]), axis=-1)
    if not d.max() < MAX_NODE_DRIFT_M:
        fail(f"phase 15 (b): the node's centres {d.max():.4f} m from the driver's")
    worker = {tid for tid, _ in streams}
    if cuda and ({tid for tid, _ in launches} != worker or len(worker) != 1
                 or {s for _, s in launches} != {worker_stream.cuda_stream}
                 or {s for _, s in streams} != {worker_stream.cuda_stream}
                 or worker_stream.cuda_stream == torch.cuda.default_stream(device).cuda_stream):
        fail(f"phase 15 (b): K1 / K2 launched on threads / streams "
             f"{sorted({x for x in launches})}, the node's worker tracks on {sorted(set(streams))}"
             f"; its stream is {worker_stream.cuda_stream}")
    log(f"phase 15 (b): publish(rate=0) into an RGB-L node (queue {n + 1}): {n} frames tracked, "
        f"all OK, dropped 0, launches {counts} on the node's worker thread and on the stream it "
        f"tracks on, not the default ({sorted(set(streams))}); centres within "
        f"{d.max() * 1e3:.3f} mm of the driver's; {time.perf_counter() - t0:.1f} s")

    # KITTI's 10 Hz in real time, the default queue, the asynchronous planes
    sysm = System(load_config(settings, sensor=RGBL), device=device)
    sysm.async_mapping = True
    fed, done, states = {}, {}, collections.Counter()

    def on_pose_timed(t, res):
        done[t] = time.perf_counter()
        states[trk.STATE_NAMES[res.state]] += 1

    node = Node(sysm, mode="rgbl", on_pose=on_pose_timed, max_queue=NODE_MAX_QUEUE)
    feed_cloud = node.feed_cloud

    def timed_feed(t, cloud):
        fed[t] = time.perf_counter()
        feed_cloud(t, cloud)

    node.feed_cloud = timed_feed
    t0 = time.perf_counter()
    published = publish(seq, node, rate=1.0, log=log)
    t_fed = time.perf_counter() - t0
    node.stop()
    stopped_at = time.perf_counter() - t0
    tracker_stream = sysm._tracker_stream
    sysm.shutdown()
    if node._thread.is_alive() or node.error is not None:
        fail(f"phase 15 (b): stop() left the worker alive or it failed: {node.error!r}")
    if published != len(done) + node.dropped_frames:
        fail(f"phase 15 (b): published {published} != tracked {len(done)} + dropped "
             f"{node.dropped_frames}")
    if cuda and tracker_stream is not None and tracker_stream.cuda_stream != worker_stream.cuda_stream:
        fail(f"phase 15 (b): the asynchronous System took its tracking stream "
             f"{tracker_stream} and not the node's worker's ({worker_stream.cuda_stream})")
    lat = [(done[t] - fed[t]) * 1e3 for t in done]
    taken = ("the worker thread's own (not the default)" if tracker_stream is not None
             else "not taken (no keyframe job)")
    log(f"phase 15 (b): publish(rate=1.0, KITTI's 10 Hz) into an RGB-L node (queue "
        f"{NODE_MAX_QUEUE}, async_mapping): published {published} in {t_fed:.2f} s, tracked "
        f"{len(done)}, dropped {node.dropped_frames}; states {dict(states)}; feed-to-pose ms p50 "
        f"{np.percentile(lat, 50):.2f} p90 {np.percentile(lat, 90):.2f}; tracking stream "
        f"{taken}; stop() returned at {stopped_at:.2f} s with the worker ended")


def phase15_tools(cfg, seq: str, settings: str, workdir: str, traj, expect, slam, traj_out,
                  device):
    """(c) ``project_velodyne`` (then the RGB-D driver on its PNGs),
    ``train_vocabulary`` and ``evaluate_ate`` on the sequence."""
    from orb_slam3_rgbl_tpu_torch.examples import run_kitti_rgbd
    from orb_slam3_rgbl_tpu_torch.io import kitti as kitti_mod, png as png_mod
    from orb_slam3_rgbl_tpu_torch.io import trajectory as traj_io
    from orb_slam3_rgbl_tpu_torch.retrieval.tree_vocab import TreeVocabulary
    from orb_slam3_rgbl_tpu_torch.tools import evaluate_ate, project_velodyne, train_vocabulary

    n = len(expect)
    dev = device.type
    # project_velodyne into a copy of the sequence whose depth/ it writes
    pv = os.path.join(workdir, "seq_pv")
    os.makedirs(pv)
    for name in ("image_2", "velodyne", "times.txt", "calib.txt"):
        os.symlink(os.path.join(seq, name), os.path.join(pv, name))
    t0 = time.perf_counter()
    paths = project_velodyne.run(project_velodyne.parse_args(
        [pv, "--method", "InverseDilation", "--device", dev]))
    pv_ms = (time.perf_counter() - t0) * 1e3 / n
    P = project_velodyne.projection(pv)
    clouds = kitti_mod.list_velodyne(pv)
    h, w = cfg.camera.height, cfg.camera.width
    differ = []
    for i, path in enumerate(paths):
        pts, mask = kitti_mod.load_pointcloud(clouds[i], max_points=131072)
        want = project_velodyne.depth_png(pts, mask, P, h, w, "InverseDilation", 256.0, 5.0,
                                          200.0, device)
        got = png_mod.read_png(path)
        if got.dtype != np.uint16 or not np.array_equal(got, want):
            fail(f"phase 15 (c): {path} differs from the same projection done in process")
        ref = png_mod.read_png(os.path.join(seq, "depth", os.path.basename(path)))
        differ.append(float(np.mean(got != ref)))
    log(f"phase 15 (c): project_velodyne --method InverseDilation: {len(paths)} 16-bit depth "
        f"PNGs, each equal to the computation in process; {pv_ms:.2f} ms/frame; pixels unlike "
        f"the driver's own depth PNGs (rounded, from the settings' projection) mean "
        f"{np.mean(differ):.4f}")
    slam_d, results, times, rec, counts = run_driver(
        run_kitti_rgbd, [settings, pv, "--out", os.path.join(workdir, "rgbd_pv.txt")], device)
    errs, _ = check_run("RGB-D driver on project_velodyne's PNGs", results, rec, counts, expect,
                        traj, 0, 2)
    log(f"phase 15 (c): the RGB-D driver on them: {n} frames, all OK, fused from frame 2, "
        f"launches {counts}, max trans err {errs.max():.3f} m; host ms/frame "
        f"{_ms_stats(np.asarray(times) * 1e3)}")
    del slam_d

    vpath = os.path.join(workdir, "vocab.npz")
    t0 = time.perf_counter()
    voc = train_vocabulary.run(train_vocabulary.parse_args(
        [os.path.join(seq, "image_2"), "--out", vpath, "--k", str(VOCAB_K), "--depth",
         str(VOCAB_DEPTH), "--device", dev]))
    tv_ms = (time.perf_counter() - t0) * 1e3 / n
    loaded = TreeVocabulary.load(vpath, device=device)
    docs = train_vocabulary.image_descriptors(kitti_mod.list_images(seq)[:1], 1000, device)
    d0 = torch.as_tensor(docs[0].view(np.int32), device=device)
    if loaded.checksum() != voc.checksum() or not torch.equal(loaded.words(d0), voc.words(d0)):
        fail("phase 15 (c): the saved vocabulary gives other words than the one in memory")
    log(f"phase 15 (c): train_vocabulary k={VOCAB_K} depth={VOCAB_DEPTH} on {n} images: "
        f"{tv_ms:.2f} ms/image (decode, extraction, training, save); the saved file gives "
        f"frame 0's {d0.shape[0]} descriptors the same words (checksum {voc.checksum()})")

    gt_path = os.path.join(workdir, "gt.txt")
    gt = traj[:n].copy()
    gt[:, 4:7] -= traj[0, 4:7]
    traj_io.save_kitti(gt_path, gt)
    t0 = time.perf_counter()
    ate = evaluate_ate.run(evaluate_ate.parse_args([gt_path, traj_out, "--device", dev]))
    ea_ms = (time.perf_counter() - t0) * 1e3
    est = slam.trajectory()
    inproc = float(align.ate_rmse(torch.as_tensor(gt[:, 4:7], device=device),
                                  torch.as_tensor(est[:, 4:7], device=device)))
    if ate["frames"] != n or not abs(ate["ate_rmse_m"] - inproc) < 1e-6 \
            or not ate["ate_rmse_m"] < MAX_TRANS_ERR_M:
        fail(f"phase 15 (c): evaluate_ate {ate} against ate_rmse in process {inproc:.7f}")
    log(f"phase 15 (c): evaluate_ate on the driver's trajectory: {ate['frames']} frames, ATE "
        f"{ate['ate_rmse_m']:.6f} m (in process {inproc:.6f}); {ea_ms:.2f} ms")


def phase15(device, card: str):
    """The users' host-side surface on the canyon written as a KITTI
    sequence: (a) the prefetching loader and the RGB-L driver on it; (b) the online node fed by the publisher;
    (c) ``project_velodyne``, ``train_vocabulary`` and ``evaluate_ate``."""
    t0 = time.perf_counter()
    log(f"phase 15 on {card}")
    cfg = kitti_synthetic_config()
    traj, frames = render_drive(cfg, N_TOOLS, device)
    depths = dense_depths(cfg, frames, device)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        seq = os.path.join(workdir, "seq")
        expect = write_sequence(seq, cfg, frames, depths, [i * 0.1 for i in range(N_TOOLS)])
        del frames, depths
        settings = os.path.join(workdir, "settings.yaml")
        settings_yaml(cfg, settings)
        log(f"phase 15: rendered and wrote a {N_TOOLS}-frame KITTI sequence in "
            f"{time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        slam, results, traj_out = phase15_loader(seq, settings, workdir, traj, expect, device)
        t2 = time.perf_counter()
        phase15_node(seq, settings, results, device)
        t3 = time.perf_counter()
        phase15_tools(cfg, seq, settings, workdir, traj, expect, slam, traj_out, device)
        log(f"phase 15: (a) {t2 - t1:.1f} s, (b) {t3 - t2:.1f} s, (c) "
            f"{time.perf_counter() - t3:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s on {card}")


# ---- phase 16: the landmark-sharded global BA ---------------------------------------
GBA_K, GBA_M, GBA_D = 256, 65536, 4      # __graft_entry__.dryrun_multichip's problem
GBA_ITERS, GBA_CG = 6, 260               # its budget: ≥ K CG steps for a chain of poses
DENSE_K, DENSE_M = 6, 320                # the dense oracle's small problem
RANK_POSE_TOL = 2e-4                     # the dense oracle, world 2 against world 1
SCALING_RANKS = "1,2"


def gba_bars(what: str, problem, poses_gt, cam, poses, lms, single) -> str:
    """``__graft_entry__.py:117-131``'s bars on one sharded solve against
    the single-device one on the same problem: pose agreement (centre
    RMSE) < max(0.25 × the initial error, 1e-2), final cost < 0.2 × the
    initial cost and < 1.1 × the single-device cost + 1e-3."""
    from orb_slam3_rgbl_tpu_torch.optim import global_ba

    dev = problem.poses.device

    def rmse_to_gt(p):
        return float(np.sqrt(((p[:, 4:7] - poses_gt[:, 4:7]) ** 2).mean()))

    def cost_of(p, l):
        return float(global_ba.ba_cost(problem._replace(poses=torch.as_tensor(p, device=dev),
                                                        landmarks=torch.as_tensor(l, device=dev)),
                                       cam))

    p_single = single.poses.cpu().numpy()
    err_init = rmse_to_gt(problem.poses.cpu().numpy())
    agree = float(np.sqrt(((poses[:, 4:7] - p_single[:, 4:7]) ** 2).mean()))
    c0 = cost_of(problem.poses, problem.landmarks)
    cd, cs = cost_of(poses, lms), cost_of(single.poses, single.landmarks)
    if not agree < max(0.25 * err_init, 1e-2):
        fail(f"phase 16 {what}: poses {agree:.5f} from the single-device solve's (initial "
             f"error {err_init:.5f})")
    if not (cd < 0.2 * c0 and cd < 1.1 * cs + 1e-3):
        fail(f"phase 16 {what}: cost {cd:.3f}, initial {c0:.3f}, single-device {cs:.3f}")
    return (f"pose agreement {agree:.6f} (bar {max(0.25 * err_init, 1e-2):.6f}), error to the "
            f"ground truth {rmse_to_gt(poses):.6f} (initial {err_init:.6f}, single-device "
            f"{rmse_to_gt(p_single):.6f}), cost {cd:.4f} against initial {c0:.4f} and "
            f"single-device {cs:.4f}")


def phase16(device, card: str):
    """The landmark-sharded global BA: (a) ``dryrun_multichip``'s problem
    through ``make_distributed_pcg_ba`` over NCCL at world 1 (no host sync
    in the solve) and over gloo at world 2 with both ranks on this card,
    against ``global_bundle_adjust``; (b) the dense-Schur oracle at worlds 1
    and 2; (c) ``tools/bench_scaling`` at ranks 1 and 2."""
    from orb_slam3_rgbl_tpu_torch.optim import global_ba
    from orb_slam3_rgbl_tpu_torch.parallel import mesh as mesh_mod, sharded_ba
    from orb_slam3_rgbl_tpu_torch.tools import bench_scaling

    t_start = time.perf_counter()
    log(f"phase 16 on {card}")
    cam = kitti_rgbl_config().camera
    kw = dict(iterations=GBA_ITERS, cg_iters=GBA_CG)
    problem, poses_gt, _ = syn.synth_gba_problem(GBA_K, GBA_M, GBA_D, cam, device=device)
    dproblem, dposes_gt, _ = syn.synth_gba_problem(DENSE_K, DENSE_M, GBA_D, cam, device=device)
    segments = global_ba.PoseSegments(problem.obs_kf, problem.obs_mask, GBA_K)
    global_ba.global_bundle_adjust(problem, cam, segments, iterations=1, cg_iters=2)   # warm-up
    _synchronize(device)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    single = global_ba.global_bundle_adjust(problem, cam, segments, **kw)
    _synchronize(device)
    single_ms = (time.perf_counter() - t0) * 1e3
    check_gba_launches("phase 16: the single-device solve", cuda_build.launch_counts, GBA_ITERS,
                       GBA_CG, device)

    # (a), (b) at world 1: NCCL (gloo on the CPU rehearsal) in this process
    backend = "nccl" if device.type == "cuda" else "gloo"
    init, store = mesh_mod.file_store()
    m = mesh_mod.make_mesh(0, 1, backend, init, device=device)
    try:
        shard = sharded_ba.shard_problem(problem, 0, 1, m.device)
        seg1 = global_ba.PoseSegments(shard.obs_kf, shard.obs_mask, GBA_K)
        run = sharded_ba.make_distributed_pcg_ba(m, cam, **kw)
        m.all_reduce(torch.zeros(1, device=m.device))       # the communicator's set-up
        _synchronize(device)
        before = dict(m.stats)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res1 = run(shard, seg1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _synchronize(device)
        w1_ms = (time.perf_counter() - t0) * 1e3
        check_gba_launches(f"phase 16: the world-1 solve over {backend}", cuda_build.launch_counts,
                           GBA_ITERS, GBA_CG, device)
        coll = m.stats["collectives"] - before["collectives"]
        n_bytes = m.stats["bytes"] - before["bytes"]
        t0 = time.perf_counter()
        again = run(shard, seg1)
        _synchronize(device)
        w1_again_ms = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(again.poses, res1.poses) and torch.equal(again.landmarks, res1.landmarks)):
            fail("phase 16: a second world-1 solve of the same problem gave other bits")
        torch.cuda.reset_peak_memory_stats()
        with _profile() as prof:
            run(shard, seg1)
            _synchronize(device)
        work = _device_work(prof.events())
        busy, n_kernels = _busy_ms(work), len(work)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        dshard = sharded_ba.shard_problem(dproblem, 0, 1, m.device)
        dense1 = sharded_ba.make_distributed_ba(m, cam)(dshard)
        dense1 = tuple(x.cpu().numpy() for x in dense1)
    finally:
        m.close()
        shutil.rmtree(store, ignore_errors=True)
    same_as_single = bool(torch.equal(res1.poses, single.poses)
                          and torch.equal(res1.landmarks, single.landmarks))
    bars1 = gba_bars(f"world 1 ({backend})", problem, poses_gt, cam, res1.poses.cpu().numpy(),
                     res1.landmarks.cpu().numpy(), single)
    log(f"phase 16 (a): single-device global_bundle_adjust K={GBA_K} M={GBA_M} D={GBA_D} "
        f"{GBA_ITERS} LM x {GBA_CG} CG: {single_ms:.1f} ms host")
    log(f"phase 16 (a): world 1 over {backend}: {w1_ms:.1f} ms host a solve under "
        f"set_sync_debug_mode('error') (no host sync in it), {w1_again_ms:.1f} ms again without "
        f"it, the same bits twice, bit-equal to the single-device "
        f"solve: {same_as_single}; {bars1}")
    log(f"phase 16 (a): world 1 under the profiler: {n_kernels} kernels, device busy "
        f"{busy:.3f} ms; {coll} collectives a solve ({coll / GBA_ITERS:.1f} an LM iteration), "
        f"{n_bytes} bytes ({n_bytes / GBA_ITERS:.0f} an LM iteration; "
        f"sharded_ba.comm_bytes {sharded_ba.comm_bytes(GBA_K, GBA_CG)}; the JAX tool's budget "
        f"{sharded_ba.comm_per_lm_iter_bytes(GBA_K, GBA_CG)}); peak memory {peak_mb:.0f} MiB")
    if coll != GBA_ITERS * (2 * GBA_CG + 3) + 1:
        fail(f"phase 16: {coll} collectives in a world-1 solve")

    # (a), (b) at world 2: gloo, both ranks on this card
    backend2, devs = mesh_mod.rank_layout(2, device)
    if backend2 != "gloo":
        fail(f"phase 16: world 2 on {devs} would run over {backend2}, not gloo on one card")
    t0 = time.perf_counter()
    pcg2, dense2 = sharded_ba.solve_on_ranks(
        [(problem, cam, "pcg", kw), (dproblem, cam, "dense", {})], 2, device, repeats=2,
        timeout_s=900)
    spawn_s = time.perf_counter() - t0
    first = pcg2[0]["poses"][0]
    for r in pcg2:
        if any(p.tobytes() != first.tobytes() for p in r["poses"]):
            fail("phase 16: world 2's replicated poses differ between ranks or solves")
    lms2 = np.concatenate([r["landmarks"][0] for r in pcg2])
    if any(r["landmarks"][1].tobytes() != r["landmarks"][0].tobytes() for r in pcg2):
        fail("phase 16: a second world-2 solve gave other landmark bits")
    bars2 = gba_bars("world 2 (gloo)", problem, poses_gt, cam, first, lms2, single)
    w2_ms = [max(r["seconds"][i] for r in pcg2) * 1e3 for i in range(2)]
    log(f"phase 16 (a): world 2 over gloo on one card ({devs}): landmarks "
        f"{[r['n_landmarks'] for r in pcg2]}, host ms a solve (slowest rank) "
        f"{w2_ms[0]:.1f} then {w2_ms[1]:.1f}; poses bit-equal on both ranks and in both solves; "
        f"{pcg2[0]['collectives'][1]} collectives, {pcg2[0]['bytes'][1]} bytes a solve; {bars2}; "
        f"the group's spawn and both solves {spawn_s:.1f} s")
    d2 = dense2[0]["poses"][0]
    if any(r["poses"][i].tobytes() != d2.tobytes() for r in dense2 for i in range(2)):
        fail("phase 16 (b): the dense oracle's poses differ between ranks or solves")
    d_err = float(np.abs(d2 - dense1[0]).max())

    def derr(p):
        return float(np.sqrt(((p[:, 4:7] - dposes_gt[:, 4:7]) ** 2).mean()))

    d_init = derr(dproblem.poses.cpu().numpy())
    if not (d_err < RANK_POSE_TOL and derr(d2) < derr(dense1[0]) + RANK_POSE_TOL
            and derr(dense1[0]) < d_init):
        fail(f"phase 16 (b): dense oracle world 2 vs 1 {d_err:.2e}, errors {derr(dense1[0]):.5f} "
             f"/ {derr(d2):.5f} (initial {d_init:.5f})")
    log(f"phase 16 (b): dense oracle K={DENSE_K} M={DENSE_M}: world 2 within {d_err:.2e} of world "
        f"1 (bar {RANK_POSE_TOL}), pose error to the ground truth {derr(dense1[0]):.5f} / "
        f"{derr(d2):.5f} (initial {d_init:.5f})")

    # (c) the scaling tool at ranks 1 and 2
    out_json = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_scaling_"), "scaling.json")
    t0 = time.perf_counter()
    rows = bench_scaling.main([out_json, "--ranks", SCALING_RANKS, "--device", device.type])
    if not all(r["cost_agrees"] for r in rows):
        fail(f"phase 16 (c): bench_scaling's costs disagree: {rows}")
    shutil.rmtree(os.path.dirname(out_json), ignore_errors=True)
    log(f"phase 16 (c): tools/bench_scaling --ranks {SCALING_RANKS}: "
        + "; ".join(f"{r['n_dev']} rank(s) steady {r['steady_s'] * 1e3:.1f} ms, first "
                    f"{r['first_s'] * 1e3:.1f} ms, {r['lm_per_shard']} landmarks a shard, cost "
                    f"{r['final_cost']:.3f}, {r['all_reduced_per_lm_iter_bytes']:.0f} bytes "
                    f"all-reduced an LM iteration (JAX budget {r['comm_per_lm_iter_bytes']})"
                    for r in rows)
        + f" ({time.perf_counter() - t0:.1f} s)")
    log(f"phase 16: {time.perf_counter() - t_start:.1f} s on {card}")


# ---- phase 17: the live viewer, the --viz driver and the two map probes ---------------
N_VIEWER = 21             # frames of phase 2's canyon, with and without the viewer
VIEWER_HZ = 2.0
N_VIZ_DRIVER = 11         # frames of the sequence the --viz driver runs
PROBE_REPS = 3            # map_stage_probe's n_reps
MAX_PROBE_ATE_RISE_M = 0.01   # gba_probe: keyframe ATE over the 3 x 2 iterations


def _http_get(port: int, path: str) -> bytes:
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10).read()


def phase17_viewer(cfg, frames, device, workdir: str):
    """(a) The canyon frames through ``track_rgbl`` without, then with
    ``start_viewer(hz=2.0, http_port=0)``, in this process."""
    from orb_slam3_rgbl_tpu_torch.io.png import read_png
    from orb_slam3_rgbl_tpu_torch.viz import viewer as vz
    from orb_slam3_rgbl_tpu_torch.viz.live import LiveViewer

    def check(what, results, counts):
        if any(r.state != trk.OK for r, _ in results):
            fail(f"phase 17 (a) {what}: states {[trk.STATE_NAMES[r.state] for r, _ in results]}")
        if counts.get("fast_and_blur") != len(results) or counts.get("brief_continuous") != len(results):
            fail(f"phase 17 (a) {what}: launch counts {counts} over {len(results)} frames; "
                 f"expected 1 K1 and 1 K2 a frame")
        return [ms for i, (r, ms) in enumerate(results) if i > 1]

    cuda_build.reset_launch_counts()
    _, plain = drive(cfg, frames, device)
    plain_ms = check("without the viewer", plain, dict(cuda_build.launch_counts))

    out = os.path.join(workdir, "viewer")
    render_ms = []
    orig = LiveViewer._render_once

    def timed(self):
        t = time.perf_counter()
        orig(self)
        render_ms.append((time.perf_counter() - t) * 1e3)

    LiveViewer._render_once = timed
    sysm = System(cfg, enable_mapping=False, device=device)
    sysm.CLOUD_CAP = frames[0][1].shape[0]
    try:
        viewer = sysm.start_viewer(out_dir=out, hz=VIEWER_HZ, http_port=0)
        cuda_build.reset_launch_counts()
        sysm, viewed = drive(cfg, frames, device, sysm=sysm)
        counts = dict(cuda_build.launch_counts)
        viewed_ms = check("with the viewer", viewed, counts)
        t0 = time.time()
        while viewer.frames_rendered < 1 and time.time() - t0 < 30:
            time.sleep(0.1)
        rendered = viewer.frames_rendered
        frame_png = read_png(os.path.join(out, "live_frame.png"))
        map_png = read_png(os.path.join(out, "live_map.png"))
        html = _http_get(viewer.http_port, "/")
        png = _http_get(viewer.http_port, "/live_frame.png")
        thread = viewer._thread
        sysm.shutdown()
    finally:
        LiveViewer._render_once = orig
    cam = cfg.camera
    if rendered < 1:
        fail("phase 17 (a): the viewer rendered nothing")
    if frame_png.shape != (cam.height + vz.BAR_H, cam.width, 3) or map_png.shape != (
            vz.MAP_SIZE[1], vz.MAP_SIZE[0], 3):
        fail(f"phase 17 (a): live_frame.png {frame_png.shape}, live_map.png {map_png.shape}")
    if b"live_frame.png" not in html or png[:4] != b"\x89PNG":
        fail("phase 17 (a): the viewer's HTTP server did not serve its index and frame")
    if sysm._viewer is not None or thread is None or thread.is_alive():
        fail("phase 17 (a): shutdown() left the viewer running")
    log(f"phase 17 (a): {len(frames)} frames at {cam.width}x{cam.height}, every frame OK with 1 "
        f"K1 + 1 K2 ({counts}); host ms/frame (frames 2..) without the viewer "
        f"{_ms_stats(plain_ms)}, with it {_ms_stats(viewed_ms)} (median "
        f"{statistics.median(viewed_ms) - statistics.median(plain_ms):+.2f} ms); "
        f"{rendered} renders at {VIEWER_HZ} Hz, ms per render {_ms_stats(render_ms)}; "
        f"live_frame.png {frame_png.shape}, live_map.png {map_png.shape}, HTTP on port "
        f"{viewer.http_port} served the index and the frame; shutdown() stopped the thread")


def phase17_probes(cfg, traj, frames, device, workdir: str):
    """(c) The canyon driven with the mapping plane on (a keyframe forced
    every ``KF_EVERY``: its jobs keep the bindings consistent, which a
    tracking-only map's are not), its map saved with the ground truth, through
    ``tools/gba_probe`` and ``tools/map_stage_probe``."""
    from orb_slam3_rgbl_tpu_torch.tools import gba_probe, map_stage_probe
    from orb_slam3_rgbl_tpu_torch.utils import serialization

    sysm = System(cfg, enable_mapping=True, device=device)
    sysm.CLOUD_CAP = frames[0][1].shape[0]
    sysm, results = drive(cfg, frames, device, sysm=sysm)
    if any(r.state != trk.OK for r, _ in results):
        fail("phase 17 (c): a frame of the mapping drive is not OK")
    path = os.path.join(workdir, "canyon_map.npz")
    serialization.save_map(path, sysm.map)
    np.savez(path + ".gt.npz", traj=np.asarray(traj, np.float32))
    t0 = time.perf_counter()
    out = gba_probe.run(path, device)
    probe_s = time.perf_counter() - t0
    if out["binding_issues"]:
        fail(f"phase 17 (c): the saved map's bindings: {out['binding_issues'][:3]}")
    rise = max(r["ate"] for r in out["rounds"]) - out["ate_before"]
    if not rise < MAX_PROBE_ATE_RISE_M:
        fail(f"phase 17 (c): gba_probe's keyframe ATE rose by {rise:.4f} m "
             f"(bar {MAX_PROBE_ATE_RISE_M})")
    t1 = time.perf_counter()
    timer = map_stage_probe.main([path, str(PROBE_REPS), "--device", device.type])
    stats = timer.stats()
    log(f"phase 17 (c): gba_probe on a {out['n_kf']}-keyframe, {out['n_lm']}-landmark canyon map: "
        f"keyframe ATE {out['ate_before']:.5f} m before, "
        + ", ".join(f"{r['ate']:.5f} after {r['iterations']} (cost {r['cost']:.2f})"
                    for r in out["rounds"])
        + f" (rise {rise * 1e3:.2f} mm, bar {MAX_PROBE_ATE_RISE_M * 1e3:.0f} mm); bindings "
          f"consistent; {probe_s:.1f} s. map_stage_probe idle medians (ms): "
        + ", ".join(f"{k} {stats[k]['median_ms']:.2f}" for k in ("idle_tri", "idle_fuse",
                                                                    "idle_lba"))
        + f" ({time.perf_counter() - t1:.1f} s)")


def phase17_driver(cfg, traj, frames, device, workdir: str):
    """(b) The RGB-L driver with ``--viz`` on the first frames written as a
    KITTI sequence: the map view is written and decodes."""
    from orb_slam3_rgbl_tpu_torch.examples import run_kitti_rgbl
    from orb_slam3_rgbl_tpu_torch.io.png import read_png
    from orb_slam3_rgbl_tpu_torch.viz import viewer as vz

    seq = os.path.join(workdir, "seq")
    frames = frames[:N_VIZ_DRIVER]
    expect = write_sequence(seq, cfg, frames, dense_depths(cfg, frames, device),
                            [i * 0.1 for i in range(len(frames))])
    settings = os.path.join(workdir, "settings.yaml")
    settings_yaml(cfg, settings)
    viz = os.path.join(workdir, "rgbl_map.png")
    slam, results, times, rec, counts = run_driver(
        run_kitti_rgbl, [settings, seq, "--out", os.path.join(workdir, "rgbl.txt"), "--viz", viz],
        device)
    errs, _ = check_run("phase 17 (b) RGB-L driver --viz", results, rec, counts, expect, traj, 0, 2)
    img = read_png(viz)
    if img.shape != (vz.MAP_SIZE[1], vz.MAP_SIZE[0], 3) or not (img != 255).any():
        fail(f"phase 17 (b): --viz wrote a {img.shape} image with nothing drawn")
    log(f"phase 17 (b): the RGB-L driver with --viz over {len(frames)} frames: all OK, launches "
        f"{counts}, max trans err {errs.max():.3f} m; the map view {img.shape} written and decoded "
        f"({os.path.getsize(viz)} bytes)")


def phase17(device, card: str):
    """The viewer and the probes on phase 2's canyon: (a) the live viewer
    during a full-width drive, (b) the RGB-L driver's ``--viz``, (c) the map
    probes on the drive's map."""
    t0 = time.perf_counter()
    log(f"phase 17 on {card}")
    cfg = kitti_synthetic_config()
    traj, frames = render_drive(cfg, N_VIEWER, device)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_viewer_")
    try:
        t1 = time.perf_counter()
        phase17_viewer(cfg, frames, device, workdir)
        t2 = time.perf_counter()
        phase17_probes(cfg, traj, frames, device, workdir)
        t3 = time.perf_counter()
        phase17_driver(cfg, traj, frames, device, workdir)
        log(f"phase 17: (a) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, (b) "
            f"{time.perf_counter() - t3:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 17: {time.perf_counter() - t0:.1f} s on {card}")


# flags that run one group of phases in a process of its own; without
# arguments the script runs phases 1-5 and then starts one process for each
# group (``run_children``): each is bound by its host's launch rate, with the
# card idle most of the time, and a process slows down as it ages (§7 of
# PERF.md), so the groups run fresh and side by side
CHILD_FLAGS = ("--loop-phases", "--canyon-phases", "--phase13", "--phase14", "--phase15",
               "--phase16", "--phase17", "--gba-inertial", "--gba-lm")


def flag_value(argv, flag: str):
    """The argument after ``flag``, unless it is missing or another flag."""
    i = argv.index(flag) + 1
    return argv[i] if i < len(argv) and not argv[i].startswith("--") else None


def run_children(children):
    """Run ``chip_smoke.py <args>`` for every (what, args) of ``children``,
    all at once on this card, each with its share of the host's cores, and
    relay their output in order once all have ended; returns their standard
    outputs. Fails as soon as one fails; the others are killed when this process exits (``atexit``;
    SIGTERM exits through it)."""
    threads = str(max(1, (os.cpu_count() or 1) // len(children)))
    env = dict(os.environ, OMP_NUM_THREADS=threads)
    runs = []
    for what, args in children:
        fd_out, out_path = tempfile.mkstemp(prefix="chip_smoke_child_", suffix=".out")
        fd_err, err_path = tempfile.mkstemp(prefix="chip_smoke_child_", suffix=".err")
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                                stdout=fd_out, stderr=fd_err, env=env)
        os.close(fd_out)
        os.close(fd_err)
        runs.append((what, proc, out_path, err_path))

    def stop():
        for _, proc, out_path, err_path in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for path in (out_path, err_path):
                if os.path.exists(path):
                    os.remove(path)

    def relay(run):
        _, _, out_path, err_path = run
        with open(out_path) as f:
            out = f.read()
        sys.stdout.write(out)
        with open(err_path) as f:
            sys.stderr.write(f.read())
        sys.stdout.flush()
        sys.stderr.flush()
        return out

    atexit.register(stop)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    log(f"started at {time.perf_counter() - T_START:.1f} s, {threads} threads each: "
        + "; ".join(f"{what} (pid {proc.pid})" for what, proc, *_ in runs))
    pending = list(runs)
    while pending:
        time.sleep(1.0)
        for run in [r for r in pending if r[1].poll() is not None]:
            pending.remove(run)
            log(f"{run[0]}: ended at {time.perf_counter() - T_START:.1f} s")
            if run[1].returncode != 0:
                relay(run)
                fail(f"{run[0]} exited with {run[1].returncode}")
    return [relay(run) for run in runs]


def loop_phases(device, card: str):
    """Phases 6, 8 and 9 on one rendered loop drive: the loop-closing plane
    and relocalization, the tree vocabulary, the asynchronous planes."""
    t_start = time.perf_counter()
    loop_cfg = loop_closing_config()
    loop_traj, loop_frames = render_loop_drive(loop_cfg, device)
    torch.cuda.synchronize()
    log(f"rendered {N_LOOP} frames of the loop drive in {time.perf_counter() - t_start:.1f} s")
    # ---- phase 6: the loop-closing plane ------------------------------------
    loop_run = phase6_loop(loop_cfg, loop_traj, loop_frames[:N_LOOP_SHORT], device, 0)
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
    log(f"phases 6 and 8's vocabulary: {time.perf_counter() - t_start:.1f} s")
    # ---- phase 8, second half: the loop drive with vocab_path set ------------
    phase8_vocab_drive(loop_cfg, loop_traj, loop_frames[:N_LOOP_SHORT], vocab_path, device)
    # ---- phase 9: the asynchronous planes on phase 6's frames ----------------
    phase9_async(loop_cfg, loop_traj, loop_frames, device, sync_loop)
    log(f"phases 6, 8 and 9: {time.perf_counter() - t_start:.1f} s on {card}")


def canyon_phases(device, card: str, id_depth):
    """Phases 7, 10, 11 and 12 on phase 2's canyon, rendered again;
    ``id_depth`` is phase 2's ``track.depth`` span (host ms, device busy
    ms, kernels), which phase 10 prints beside its own."""
    t_start = time.perf_counter()
    cfg = kitti_synthetic_config()
    traj, frames = render_drive(cfg, N_DRIVE + N_BLANK + N_AFTER, device)
    # ---- phase 7: the atlas weld ---------------------------------------------
    phase7(loop_closing_config(), traj, frames, device)
    # ---- phase 10: the two other LiDAR upsamplers on the fused step ----------
    phase10_upsamplers(cfg, traj, frames, device, id_depth)
    log(f"phases 7 and 10: {time.perf_counter() - t_start:.1f} s")
    # ---- phase 11: the KITTI drivers on a sequence written to disk ------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke_kitti_")
    try:
        phase11_kitti(cfg, traj, frames[:N_KITTI], device, workdir)
        # ---- phase 12: the stereo and monocular sensors (and the stereo driver
        # on phase 11's sequence) ---------------------------------------------
        phase12(traj, frames[:N_DRIVE], device, workdir, card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phases 7, 10, 11 and 12: {time.perf_counter() - t_start:.1f} s on {card}")

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
    argv = sys.argv[1:]
    if any(flag in argv for flag in CHILD_FLAGS):
        if "--loop-phases" in argv:
            loop_phases(device, card)
        if "--gba-inertial" in argv:
            print(json.dumps({"gba_kernels": gba_inertial_kernels(device)}), flush=True)
        if "--gba-lm" in argv:
            print(json.dumps({"gba_kernels": gba_lm_kernels(device)}), flush=True)
        if "--canyon-phases" in argv:
            value = flag_value(argv, "--canyon-phases")
            canyon_phases(device, card, json.loads(value) if value else (0.0, 0.0, 0))
        if "--phase13" in argv:
            phase13(device, card, tuple(m for m in EUROC_MODES if m in argv) or tuple(EUROC_MODES))
        if "--phase14" in argv:
            phase14(device, card)
        if "--phase15" in argv:
            phase15(device, card)
        if "--phase16" in argv:
            phase16(device, card)
        if "--phase17" in argv:
            phase17(device, card)
        log(card)
        return
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
    if counts4 != {**dict.fromkeys(counts4, 0), "fast_and_blur": N_BINNED, "brief_blocks": N_BINNED}:
        fail(f"binned extraction launch counts {counts4}; expected 1 K1 and 1 K3 per frame and "
             f"nothing else")
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

    # ---- phases 6-17: five processes of their own on this card, each started
    # fresh (phases 1-5, the kernels' times and the main path's latency, had
    # the host and the card to themselves) -------------------------------------
    del late, frames
    id_depth = prof_stats[0][3].get("track.depth", (0.0, 0.0, 0)) if prof_stats else (0.0, 0.0, 0)
    outputs = run_children([
        ("phases 6, 8 and 9 (the loop drive)", ["--loop-phases"]),
        ("phases 7, 10, 11 and 12 (the canyon)", ["--canyon-phases", json.dumps(list(id_depth))]),
        ("phase 13 stereo-inertial, phases 14 and 15",
         ["--phase13", "stereo-inertial", "--phase14", "--phase15"]),
        ("phase 13 mono-inertial", ["--phase13", "mono-inertial"]),
        ("phases 16 and 17 (the sharded BA, the viewer, the probes)", ["--phase16", "--phase17"]),
    ])
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
    # G1 and G2, held and timed on the loop event's global BA (phase 6), and
    # G3 with the 15-wide updates at the inertial cell's shapes
    gba = [json.loads(line)["gba_kernels"] for line in outputs[0].splitlines()
           if line.startswith('{"gba_kernels"')]
    if len(gba) != 1:
        fail(f"the loop phases printed {len(gba)} gba_kernels lines, expected 1")
    kernels += gba[0]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    # the script drives one card, whatever else is visible
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
