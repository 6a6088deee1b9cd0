"""KITTI RGB-D driver (counterpart of ``examples/run_kitti_rgbd.py``; the
reference's ``rgbd_kitti``, ``rgbd_kitti_map_saving`` and
``rgbd_kitti_map_loading`` examples): run a sequence with 16-bit depth PNGs
beside its images, optionally load an atlas first or save one at the end,
print the per-frame tracking time (median and mean) and save
``CameraTrajectory.txt`` in KITTI format.

    python -m orb_slam3_rgbl_tpu_torch.examples.run_kitti_rgbd <settings.yaml> \\
        <sequence_dir> [--depth-dir depth] [--depth-factor F] \\
        [--out CameraTrajectory.txt] [--frames N] [--save-atlas atlas.npz] \\
        [--load-atlas atlas.npz] [--device cuda|cpu]

Depth in metres is the PNG's value over ``--depth-factor`` (the settings
file's ``RGBD.DepthMapFactor`` unless given). An atlas of either package
loads (``utils/serialization.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--depth-dir", default="depth", help="subdirectory with 16-bit depth PNGs")
    ap.add_argument("--depth-factor", type=float, default=0.0,
                    help="depth = png / factor (0: the settings file's DepthMapFactor)")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--save-atlas", default="", help="write the atlas here at the end")
    ap.add_argument("--load-atlas", default="", help="resume from this atlas")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """Track the sequence; returns (System, per-frame TrackResults, per-frame
    host seconds). A frame's time ends when the System's stream has
    finished its work."""
    from orb_slam3_rgbl_tpu_torch.config import RGBD, load_config
    from orb_slam3_rgbl_tpu_torch.io import png
    from orb_slam3_rgbl_tpu_torch.io.kitti import list_images, load_image_gray, load_times
    from orb_slam3_rgbl_tpu_torch.slam.system import System

    cfg = load_config(args.settings, sensor=RGBD)
    slam = System(cfg, device=args.device)
    if args.load_atlas:
        slam.load_atlas(args.load_atlas)

    times_f = load_times(args.sequence)
    images = list_images(args.sequence)
    ddir = os.path.join(args.sequence, args.depth_dir)
    depths = [os.path.join(ddir, f) for f in sorted(os.listdir(ddir)) if f.endswith(".png")]
    factor = args.depth_factor or cfg.depth_map_factor
    n = min(len(images), len(depths))
    if args.frames > 0:
        n = min(n, args.frames)

    results, times = [], []
    for i in range(n):
        img = load_image_gray(images[i])
        depth = png.read_png(depths[i]).astype(np.float32) / factor
        t0 = time.perf_counter()
        res = slam.track_rgbd(img, depth, float(times_f[i]))
        if slam.device.type == "cuda":
            torch.cuda.current_stream(slam.device).synchronize()
        results.append(res)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"[{i}/{n}] state={res.state} inliers={res.n_inliers}", file=sys.stderr)

    arr = np.asarray(times)
    print(f"median tracking time: {np.median(arr):.4f}", file=sys.stderr)
    print(f"mean tracking time: {arr.mean():.4f}", file=sys.stderr)
    slam.save_trajectory_kitti(args.out)
    print(f"trajectory saved to {args.out}", file=sys.stderr)
    if args.save_atlas:
        slam.save_atlas(args.save_atlas)
        print(f"atlas saved to {args.save_atlas}", file=sys.stderr)
    return slam, results, times


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
