#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phase 0 builds the CUDA kernels from ``orb_slam3_rgbl_tpu_torch/csrc``.
Phase 1 runs each kernel at the main path's shapes on a rendered
1241×376 frame (K1 ``fast_and_blur`` on all 8 pyramid levels, K2
``brief_continuous`` on the frame's 2000 keypoints), compares it with its
plain version and times both. Phase 2 drives the main path — the fused
RGB-L tracking step through ``Tracker.track_image_rgbl`` →
``FastPath.sync/run/advance`` — at the KITTI configuration (1241×376,
2000 features, 8 levels, a 131,072-point cloud, an 8192-landmark window)
over a synthetic street-canyon drive, and checks inliers, launch counts,
the absence of host syncs inside the step and the trajectory against
ground truth.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it. Without a CUDA device the script exits 1 at once.
It uses one card: unless ``CUDA_VISIBLE_DEVICES`` is set, it sees only
the first. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch import cuda_build
from orb_slam3_rgbl_tpu_torch import synthetic as syn
from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.ops import brief_cuda, fast as fast_ops, frontend_cuda
from orb_slam3_rgbl_tpu_torch.ops import orb as orb_ops, pyramid as pyr_ops
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState
from orb_slam3_rgbl_tpu_torch.slam.tracking import Tracker

SEED = 0
N_TRACKED = 20          # timed fused frames after the initialization frame
N_PROFILED = 3          # further fused frames under torch.profiler
CLOUD_AZ, CLOUD_EL = 2048, 64   # 131,072 points (the JAX engine's CLOUD_CAP)
WINDOW_CAP = 8192
MIN_INLIERS = 30
# translation error bound against ground truth over the drive (metres),
# ~3x the error this drive shows on an H100 (PERF.md §2); the reduced-size
# drive of tests/test_torch_step.py holds the port within 5 mm of the JAX
# tracker on the same frames
MAX_TRANS_ERR_M = 0.25
BLUR_TOL = 1e-3         # K1 blur vs pyramid.gaussian_blur (tests/test_brief_pallas.py bar)

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): 3.35 TB/s of HBM and
# 67 TFLOP/s of f32 outside the tensor cores. The 67 counts a fused
# multiply-add as two operations; the kernels' operations (sub, min, max,
# mul, add, compare, each its own instruction) retire at most one per lane
# per clock, half that rate. min/max may issue slower still; the bound
# does not assume so, and stays a floor.
HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2
# K1 operations per pixel, as the plain version counts them: 16 contrasts,
# 2 × 64 min/max for the 9-long arc windows (prefix 2, 4, 8, +1), 2 × 15
# to reduce over arcs, 3 for the score, 28 for the two 7-tap blur passes
# (7 multiplies and 7 adds each, unfused)
K1_OPS_PER_PIXEL = 16 + 128 + 30 + 3 + 28


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
    from torch.profiler (kernel time alone, without launch gaps)."""
    fn()
    torch.cuda.synchronize()
    with _profile() as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(_ms(e) for e in prof.events() if name in e.name and _on_device(e)) / iters


def bound(n_bytes: float, n_ops: float):
    """(least ms, what bounds it) for moving n_bytes and issuing n_ops
    single f32 instructions."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def brief_bytes(comp, corners, idx) -> float:
    """Least bytes K2 must move on these inputs: each composite pixel that
    some test samples, once (with the plain version's clamps), the index
    tables, the corners and the output words."""
    Hc, Wc = comp.shape
    N = corners.shape[0]
    u = corners[:, 0:1].long().clamp(0, Wc - brief_cuda.PATCH)
    v = corners[:, 1:2].long().clamp(0, Hc - brief_cuda.PATCH)
    i = idx.long().clamp(0, brief_cuda.PATCH ** 2 - 1)
    pixels = torch.unique((v + i // brief_cuda.PATCH) * Wc + u + i % brief_cuda.PATCH).numel()
    return 4.0 * pixels + idx.numel() * 4.0 + corners.numel() * 4.0 + 32.0 * N


def kitti_synthetic_config():
    """``kitti_rgbl_config()`` with its LiDAR extrinsics replaced by the
    synthetic world's axis swap."""
    cfg = kitti_rgbl_config()
    lidar = dataclasses.replace(cfg.lidar, T_velo_cam=tuple(syn.T_VELO_CAM.reshape(-1).tolist()))
    return dataclasses.replace(cfg, lidar=lidar)


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


def drive(cfg, frames, device, on_frame=None):
    """Initialize on frame 0, then track every later frame through the
    fused step. Returns the tracker and per-frame (TrackResult, host ms).
    ``on_frame(i)`` may return a context manager wrapped around frame i."""
    o = cfg.orb
    n_feat = sum(fast_ops.features_per_level(o.n_features, o.n_levels, o.scale_factor))
    tracker = Tracker(cfg, MapState.create(16, 1 << 15, n_feat), n_feat,
                      window_cap=WINDOW_CAP, device=device)
    results = []
    for i, (img, pts, mask) in enumerate(frames):
        with on_frame(i) if on_frame is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            res = tracker.track_image_rgbl(img, pts, mask, i * 0.1)
            if device.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        results.append((res, ms))
    return tracker, results


def trans_errors(traj, results) -> np.ndarray:
    est = np.stack([lie.np_se3_centers(r.pose) for r, _ in results])
    return np.linalg.norm(est - (traj[:, 4:7] - traj[0, 4:7]), axis=1)


def phase1_kernels(cfg, device) -> dict:
    """K1 and K2 against their plain versions at the main path's shapes."""
    cam, o = cfg.camera, cfg.orb
    _, frames = render_drive(cfg, 1, device, n_az=64, n_el=8)
    levels = [lv.contiguous() for lv in pyr_ops.build_pyramid(
        frames[0][0], cam.height, cam.width, o.n_levels, o.scale_factor)]
    budgets = fast_ops.features_per_level(o.n_features, o.n_levels, o.scale_factor)

    k1 = collections.Counter()
    blurs, uvs, angs = [], [], []
    for l, lv in enumerate(levels):
        H, W = lv.shape
        score, blur = frontend_cuda.fast_and_blur(lv)
        score_p, blur_p = frontend_cuda.fast_and_blur_plain(lv)
        torch.cuda.synchronize()
        if not torch.equal(score.view(torch.int32), score_p.view(torch.int32)):
            fail(f"K1 level {l} ({H}x{W}): score differs from fast_score at "
                 f"{int((score != score_p).sum())} pixels")
        err = float((blur - blur_p).abs().max())
        if not err <= BLUR_TOL:
            fail(f"K1 level {l}: blur max |diff| {err} > {BLUR_TOL}")
        ms = time_cuda(lambda: frontend_cuda.fast_and_blur(lv))
        pms = time_cuda(lambda: frontend_cuda.fast_and_blur_plain(lv), iters=20)
        dms = kernel_device_ms(lambda: frontend_cuda.fast_and_blur(lv), "fast_blur_kernel")
        log(f"K1 level {l} {H}x{W}: score bit-identical, blur max|diff| {err:.3g}, "
            f"kernel {ms:.4f} ms (device time alone {dms:.4f} ms), plain {pms:.4f} ms")
        k1.update(ms=ms, plain_ms=pms, device_ms=dms, bytes=12.0 * H * W + 28,
                  ops=K1_OPS_PER_PIXEL * H * W)
        k1["err"] = max(k1["err"], err)
        uv, _, _ = fast_ops.select_keypoints(score, budgets[l], ini_th=float(o.ini_th_fast),
                                             min_th=float(o.min_th_fast), margin=19)
        uvs.append(uv)
        angs.append(orb_ops.ic_angle(lv, uv))
        blurs.append(blur)
    log(f"K1 all 8 levels: kernel {k1['ms']:.4f} ms (device time alone {k1['device_ms']:.4f} ms), "
        f"plain {k1['plain_ms']:.4f} ms a frame")

    comp, uv_all, ang, corners, idx = brief_cuda.multilevel_inputs(blurs, uvs, angs)
    Hc, Wc = comp.shape
    N = corners.shape[0]
    d_k = brief_cuda.brief_continuous(comp, corners, idx)
    d_p = brief_cuda.brief_continuous_plain(comp, corners, idx)
    d_g = orb_ops.brief_descriptors(comp, uv_all, ang)
    torch.cuda.synchronize()
    if not torch.equal(d_k, d_p):
        fail(f"K2: {int((d_k != d_p).any(1).sum())} of {N} descriptors differ from the plain version")
    # keypoints whose patch lies inside the composite (all real ones) must
    # also equal the gather form, which clamps each sample instead
    inside = (uv_all[:, 0] >= brief_cuda.HALF) & (uv_all[:, 1] >= brief_cuda.HALF)
    if not torch.equal(d_k[inside], d_g[inside]):
        fail("K2 differs from orb.brief_descriptors on the composite")
    bits = orb_ops.unpack_descriptors_pm1(d_k) != orb_ops.unpack_descriptors_pm1(d_p)
    k2_err = float(bits.to(torch.float32).max()) if bits.numel() else 0.0
    ms2 = time_cuda(lambda: brief_cuda.brief_continuous(comp, corners, idx))
    pms2 = time_cuda(lambda: brief_cuda.brief_continuous_plain(comp, corners, idx))
    gms2 = time_cuda(lambda: orb_ops.brief_descriptors(comp, uv_all, ang))
    dms2 = kernel_device_ms(lambda: brief_cuda.brief_continuous(comp, corners, idx), "brief_kernel")
    log(f"K2 {N} keypoints on a {Hc}x{Wc} composite: bit-identical to the plain version "
        f"and to orb.brief_descriptors ({int(inside.sum())} in-patch keypoints); "
        f"kernel {ms2:.4f} ms (device time alone {dms2:.4f} ms), plain {pms2:.4f} ms, "
        f"gather form {gms2:.4f} ms")
    k2_bytes = brief_bytes(comp, corners, idx)
    k2_ops = 512.0 * N      # 256 compares + 256 bit packs
    k1_bound, k2_bound = bound(k1["bytes"], k1["ops"]), bound(k2_bytes, k2_ops)
    log(f"bounds: K1 {k1['bytes']:.0f} B, {k1['ops']:.0f} ops -> {k1_bound[0] * 1e3:.3f} us "
        f"({k1_bound[1]}); K2 {k2_bytes:.0f} B, {k2_ops:.0f} ops -> {k2_bound[0] * 1e3:.3f} us "
        f"({k2_bound[1]})")
    return {
        "fast_and_blur": dict(ms=k1["ms"], plain_ms=k1["plain_ms"], err=float(k1["err"]),
                              bound=k1_bound),
        "brief_continuous": dict(ms=ms2, plain_ms=pms2, err=k2_err, bound=k2_bound),
    }


def profile_frames():
    """(context manager factory, stats): torch.profiler over one frame.
    Appends per frame (device busy ms, kernel count, {kernel name: [ms,
    calls]}, {step span: (host ms, device busy ms, kernels)}). Busy time
    sums kernel durations; a kernel belongs to the step span
    (``compiled.STEP_SPANS``) whose device-side range holds its start."""
    stats = []

    @contextlib.contextmanager
    def ctx():
        with _profile() as prof:
            yield
        events = list(prof.events())
        spans = [e for e in events if e.name.startswith("track.")]
        host_ms = {e.name: _ms(e) for e in spans if not _on_device(e)}
        dev_spans = [e for e in spans if _on_device(e)]
        by_name = collections.defaultdict(lambda: [0.0, 0])
        by_span = collections.defaultdict(lambda: [0.0, 0])
        for e in events:
            if not _on_device(e) or e.name.startswith("track."):
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


@contextlib.contextmanager
def event_span(out: list):
    """CUDA events around one frame: device span from its first enqueued
    work to its last (includes gaps where the card waits on the host)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    end.synchronize()
    out.append(start.elapsed_time(end))


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

    cfg = kitti_synthetic_config()

    # ---- phase 1: kernels against plain versions ----------------------------
    k = phase1_kernels(cfg, device)

    # ---- phase 2: the main path ---------------------------------------------
    n_frames = 1 + N_TRACKED + N_PROFILED
    t0 = time.perf_counter()
    traj, frames = render_drive(cfg, n_frames, device)
    torch.cuda.synchronize()
    log(f"rendered {n_frames} frames at {cfg.camera.width}x{cfg.camera.height} with "
        f"{frames[0][1].shape[0]}-point clouds in {time.perf_counter() - t0:.1f} s")
    prof_ctx, prof_stats = profile_frames()
    span_ms = []

    def on_frame(i):
        if i > N_TRACKED:
            return prof_ctx()
        return event_span(span_ms) if i >= 1 else contextlib.nullcontext()

    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    tracker, results = drive(cfg, frames, device, on_frame=on_frame)
    counts = dict(cuda_build.launch_counts)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    check_no_sync(tracker, frames[-1], device)

    inliers = [r.n_inliers for r, _ in results[1:]]
    errs = trans_errors(traj, results)
    host_ms = [ms for _, ms in results[1:1 + N_TRACKED]]
    log("frame inliers: " + " ".join(str(n) for n in inliers))
    log("trans err m: " + " ".join(f"{e:.3f}" for e in errs))
    if min(inliers) < MIN_INLIERS:
        fail(f"a tracked frame kept {min(inliers)} inliers (< {MIN_INLIERS})")
    if counts["fast_and_blur"] != 8 * n_frames or counts["brief_continuous"] != n_frames:
        fail(f"launch counts {counts} over {n_frames} frames; expected 8 and 1 per frame")
    if not float(errs.max()) < MAX_TRANS_ERR_M:
        fail(f"translation error {errs.max():.3f} m >= {MAX_TRANS_ERR_M} m")
    q = statistics.quantiles(host_ms, n=10)
    log(f"main path: {N_TRACKED} timed frames, host ms/frame median {statistics.median(host_ms):.2f} "
        f"p90 {q[-1]:.2f}; device span ms/frame median {statistics.median(span_ms):.2f}; "
        f"launches {counts} over {n_frames} frames (8 and 1 per frame); "
        f"max trans err {errs.max():.3f} m (bound {MAX_TRANS_ERR_M}); peak memory {peak_mb:.0f} MiB")
    if prof_stats and prof_stats[0][1] > 0:
        log(f"profiler: device busy ms/frame {', '.join(f'{s[0]:.2f}' for s in prof_stats)}; "
            f"kernels/frame {', '.join(str(s[1]) for s in prof_stats)}")
        for span, (host, busy, n) in sorted(prof_stats[0][3].items()):
            log(f"  span {span:20s} host {host:8.2f} ms  device busy {busy:7.3f} ms  kernels {n}")
        for name, (ms, calls) in sorted(prof_stats[0][2].items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"  {ms:8.3f} ms {calls:6d} calls  {name[:110]}")
    else:
        log("profiler: no device events recorded (device busy time not measured)")

    kernels = [
        {"name": "fast_and_blur", "route": "cuda",
         "source": "orb_slam3_rgbl_tpu_torch/csrc/frontend.cu",
         "replaces": "orb_slam3_rgbl_tpu/ops/frontend_pallas.py:124"},
        {"name": "brief_continuous", "route": "cuda",
         "source": "orb_slam3_rgbl_tpu_torch/csrc/brief.cu",
         "replaces": "orb_slam3_rgbl_tpu/ops/brief_pallas.py:425"},
    ]
    for entry in kernels:
        m = k[entry["name"]]
        entry.update(launches=counts[entry["name"]], max_abs_err=m["err"], ms=m["ms"],
                     plain_ms=m["plain_ms"], bound_ms=m["bound"][0], bound_by=m["bound"][1],
                     library_ms=None)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
