"""TUM RGB-D driver (counterpart of ``examples/run_tum_rgbd.py``; the
reference's ``rgbd_tum`` example): a TUM RGB-D sequence in (rgb.txt /
depth.txt associated by nearest timestamp, as ``evaluation/associate.py``
does), the per-frame tracking time (median and mean) printed, TUM-format
trajectories out, ready for ``evaluation/evaluate_ate.py``.

    python -m orb_slam3_rgbl_tpu_torch.examples.run_tum_rgbd <settings.yaml> \\
        <sequence_dir> [--frames N] [--out CameraTrajectory.txt] \\
        [--out-kf KeyFrameTrajectory.txt] [--device cuda|cpu]
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
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--out-kf", default="KeyFrameTrajectory.txt")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """Track the sequence; returns (System, per-frame TrackResults, per-frame
    host seconds). A frame's time ends when the System's stream has
    finished its work."""
    from orb_slam3_rgbl_tpu_torch.config import RGBD, load_config
    from orb_slam3_rgbl_tpu_torch.io.euroc import TumRgbdSequence
    from orb_slam3_rgbl_tpu_torch.slam.system import System

    cfg = load_config(args.settings, sensor=RGBD)
    slam = System(cfg, device=args.device)
    seq = TumRgbdSequence(args.sequence, depth_factor=cfg.depth_map_factor)
    n = len(seq) if args.frames <= 0 else min(args.frames, len(seq))

    results, times = [], []
    for i in range(n):
        img, depth, _, t = seq.frame(i)
        t0 = time.perf_counter()
        res = slam.track_rgbd(img, depth, t)
        if slam.device.type == "cuda":
            torch.cuda.current_stream(slam.device).synchronize()
        results.append(res)
        times.append(time.perf_counter() - t0)
        if i % 100 == 0:
            print(f"[{i}/{n}] state={res.state} inliers={res.n_inliers}", file=sys.stderr)

    arr = np.asarray(times)
    print(f"median tracking time: {np.median(arr):.4f}", file=sys.stderr)
    print(f"mean tracking time: {arr.mean():.4f}", file=sys.stderr)
    slam.save_trajectory_tum(args.out)
    slam.save_keyframe_trajectory_tum(args.out_kf)
    print(f"trajectories saved to {args.out} / {args.out_kf}", file=sys.stderr)
    return slam, results, times


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
