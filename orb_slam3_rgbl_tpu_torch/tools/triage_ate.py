"""ATE triage harness (counterpart of the root ``tools/triage_ate.py``): drive
the two-lap box world under toggled subsystems to find where the
trajectory error comes from.

    python -m orb_slam3_rgbl_tpu_torch.tools.triage_ate <mode> [n_frames] \\
        [--cadence 4] [--world small|bench] [--device cuda|cpu]

modes: full   — asynchronous mapping, loop closing and global BA (the bench's regime)
       noloop — loop closing off (odometry and local mapping only)
       nogba  — loop closing on, the global BA off
       sync   — the synchronous mapping plane (no worker threads)
       nopg   — loop detection and fusion on, the pose graph off

From frame 20 a keyframe is forced every ``--cadence`` frames (0: the
natural policy). ``--world bench`` is the engine bench's geometry at KITTI
width (a radius-22 circle in a 72 m room); ``small`` the 320×192 one (a
radius-6 circle). Prints the stage table and an error trace on stderr, then
one JSON line with the JAX harness's keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

MODES = ("full", "noloop", "nogba", "sync", "nopg")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="full", choices=MODES)
    ap.add_argument("n_frames", nargs="?", type=int, default=300)
    ap.add_argument("--cadence", type=int, default=4,
                    help="force a keyframe every N frames from frame 20 (0: natural policy)")
    ap.add_argument("--world", default="small", choices=("small", "bench"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def skip_pose_graph(closer):
    """``nopg``: every loop correction of ``closer`` keeps the keyframe
    poses (``_correct_loop(run_pose_graph=False)``), on the inline mapping
    plane and the asynchronous loop plane alike, as the JAX harness does."""
    correct = closer._correct_loop
    closer._correct_loop = lambda ev, run_pose_graph=True: correct(ev, run_pose_graph=False)


def run(args: argparse.Namespace) -> dict:
    """Drive the world; returns the JSON line's fields."""
    from orb_slam3_rgbl_tpu_torch import synthetic as syn
    from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
    from orb_slam3_rgbl_tpu_torch.device import resolve
    from orb_slam3_rgbl_tpu_torch.geometry.align import ate_rmse
    from orb_slam3_rgbl_tpu_torch.slam import map_state as ms, tracking as trk
    from orb_slam3_rgbl_tpu_torch.slam.system import System
    from orb_slam3_rgbl_tpu_torch.utils import logging as slam_log
    from orb_slam3_rgbl_tpu_torch.utils.profiling import StageTimer

    device = resolve(args.device)
    mode, n_frames = args.mode, args.n_frames
    slam_log.set_level(slam_log.NORMAL)
    if args.world == "bench":
        # the engine bench's geometry (KITTI width, radius-22 box)
        cfg, radius = kitti_rgbl_config(), 22.0
        w = syn.make_box_world(0, tex_size=512, half=radius + 14.0, device=device)
    else:
        cfg, radius = syn.synthetic_rgbl_config(), 6.0
        w = syn.make_box_world(0, tex_size=256, device=device)
    if mode == "noloop":
        cfg = dataclasses.replace(cfg, loop_closing=False)
    traj = syn.multi_loop_trajectory(n_frames, radius=radius,
                                     period=max((n_frames + 8) // 2, 40))
    traj[:, 4] -= radius
    cam = cfg.camera

    sysm = System(cfg, device=device)
    sysm.CLOUD_CAP = 16384
    sysm.async_mapping = mode != "sync"
    timer = StageTimer()
    sysm.timer = timer

    states = []
    for i, Twc in enumerate(traj):
        img = syn.render_image(w, Twc, cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
        pts = syn.lidar_scan(w, Twc, n_az=256, n_el=48)
        states.append(sysm.track_rgbl(img, pts, i * 0.1).state)
        if i == 20 and args.cadence > 0 and sysm.tracker is not None:
            sysm.tracker.force_kf_every = args.cadence
            sysm.tracker.deferred_kf = 0
        if i == 20 and sysm.loop_closer is not None:
            if mode == "nogba":
                sysm.loop_closer.run_gba = False
            if mode == "nopg":
                skip_pose_graph(sysm.loop_closer)
    sysm.shutdown()

    est = sysm.trajectory()
    gt = traj[: len(est)]
    gt_c = gt[:, 4:7] - gt[0, 4:7]
    err = float(ate_rmse(torch.as_tensor(est[:, 4:7], device=device),
                         torch.as_tensor(gt_c, device=device)))
    per_err = np.linalg.norm(est[:, 4:7] - gt_c, axis=1)
    print(timer.report(), file=sys.stderr)
    print(f"[{mode}] err trace (every 10th frame): "
          f"{[round(float(x), 2) for x in per_err[::10]]}", file=sys.stderr)
    return {
        "mode": mode, "ate_m": round(err, 3),
        "p50": round(float(np.percentile(per_err, 50)), 2),
        "p90": round(float(np.percentile(per_err, 90)), 2),
        "max": round(float(per_err.max()), 2),
        "argmax": int(np.argmax(per_err)),
        "ok_frac": round(float(np.mean([s == trk.OK for s in states])), 3),
        "n_kf": int(sysm.map.kf_valid.sum()),
        "deferred": int(sysm.tracker.deferred_kf),
        "loops": len(sysm.loop_closer.events) if sysm.loop_closer else 0,
        "issues": ms.check_binding_consistency(sysm.map),
    }


def main(argv=None):
    print(json.dumps(run(parse_args(argv))))


if __name__ == "__main__":
    main()
