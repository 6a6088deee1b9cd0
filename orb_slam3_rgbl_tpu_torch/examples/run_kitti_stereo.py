"""KITTI stereo driver (counterpart of ``examples/run_kitti_stereo.py``; the
reference's ``Examples/Stereo/stereo_kitti.cc``): rectified ``image_0`` /
``image_1`` pairs in, the per-frame tracking time (median and mean) printed,
``CameraTrajectory.txt`` in KITTI format out.

    python -m orb_slam3_rgbl_tpu_torch.examples.run_kitti_stereo <settings.yaml> \\
        <sequence_dir> [--out CameraTrajectory.txt] [--frames N] [--device cuda|cpu]

The settings file is the reference's (``Examples/Stereo/KITTI00-02.yaml``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """Track the sequence; returns (System, per-frame TrackResults, per-frame
    host seconds). A frame's time ends when the System's stream has
    finished its work."""
    from orb_slam3_rgbl_tpu_torch.config import STEREO, load_config
    from orb_slam3_rgbl_tpu_torch.io.kitti import list_images, load_image_gray, load_times
    from orb_slam3_rgbl_tpu_torch.slam.system import System

    cfg = load_config(args.settings, sensor=STEREO)
    slam = System(cfg, device=args.device)

    times_f = load_times(args.sequence)
    left = list_images(args.sequence, "image_0")
    right = list_images(args.sequence, "image_1")
    n = min(len(left), len(right))
    if args.frames > 0:
        n = min(n, args.frames)

    results, times = [], []
    for i in range(n):
        im_l = load_image_gray(left[i])
        im_r = load_image_gray(right[i])
        t0 = time.perf_counter()
        res = slam.track_stereo(im_l, im_r, float(times_f[i]))
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
    return slam, results, times


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
