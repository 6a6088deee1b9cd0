"""KITTI RGB-L driver (counterpart of ``examples/run_kitti_rgbl.py``; the
reference's ``Examples/RGB-L/rgbl_kitti.cc``): run a sequence, print the
per-frame tracking time as the reference does (median and mean), the stage
times, and save ``CameraTrajectory.txt`` in KITTI format.

    python -m orb_slam3_rgbl_tpu_torch.examples.run_kitti_rgbl <settings.yaml> \\
        <sequence_dir> [--out CameraTrajectory.txt] [--frames N] [--stats FILE] \\
        [--async-mapping] [--native-loader] [--viz MAP.png] [--device cuda|cpu]

The frames are decoded ahead of the loop in worker processes
(``io/native_loader.NativeKittiSequence``), so the tracking thread never
shares the interpreter lock with the PNG decoder; the stage table's ``load``
row is the loop's wait for each frame. ``--native-loader`` is accepted for
the JAX driver's command line and changes nothing. ``--viz`` writes the
top-down map view with the trajectory (``viz/viewer.plot_map``) at the end.

The sequence directory is KITTI odometry's layout (``image_2/*.png``,
``velodyne/*.bin``, ``times.txt``); the settings file is the reference's
(``Examples/RGB-L/KITTI00-02.yaml``).
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
    ap.add_argument("--stats", default="", help="write per-stage timing stats (ExecMean-style)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run mapping and loop closing on the worker planes")
    ap.add_argument("--native-loader", action="store_true",
                    help="accepted for the JAX driver's command line: the frames are "
                         "always decoded ahead of the loop in worker processes")
    ap.add_argument("--viz", default="", help="write a map plot to this path at the end")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """Track the sequence; returns (System, per-frame TrackResults, per-frame
    host seconds). A frame's time ends when the System's stream has
    finished its work."""
    from orb_slam3_rgbl_tpu_torch.config import RGBL, load_config
    from orb_slam3_rgbl_tpu_torch.io.native_loader import NativeKittiSequence
    from orb_slam3_rgbl_tpu_torch.slam.system import System
    from orb_slam3_rgbl_tpu_torch.utils.profiling import StageTimer, save_stats

    cfg = load_config(args.settings, sensor=RGBL)
    slam = System(cfg, device=args.device)
    timer = StageTimer()
    slam.timer = timer
    slam.async_mapping = bool(args.async_mapping)
    seq = NativeKittiSequence(args.sequence)
    n = len(seq) if args.frames <= 0 else min(args.frames, len(seq))

    results, times = [], []
    try:
        for i in range(n):
            t0 = time.perf_counter()
            img, pcd, mask, t = seq.next_frame()
            t1 = time.perf_counter()
            res = slam.track_rgbl(img, pcd, t, cloud_mask=mask)
            if slam.device.type == "cuda":
                torch.cuda.current_stream(slam.device).synchronize()
            dt = time.perf_counter() - t1
            results.append(res)
            times.append(dt)
            timer.record("load", t1 - t0)
            timer.record("track_total", dt)
            if i % 50 == 0:
                print(f"[{i}/{n}] state={res.state} inliers={res.n_inliers} {dt * 1e3:.1f} ms",
                      file=sys.stderr)
    finally:
        seq.close()

    arr = np.asarray(times)
    # the reference prints these two numbers (rgbl_kitti.cc)
    print(f"median tracking time: {np.median(arr):.4f}", file=sys.stderr)
    print(f"mean tracking time: {arr.mean():.4f}", file=sys.stderr)
    print(timer.report(), file=sys.stderr)

    slam.shutdown()
    slam.save_trajectory_kitti(args.out)
    print(f"trajectory saved to {args.out}", file=sys.stderr)
    if args.stats:
        save_stats(timer, args.stats)
    if args.viz:
        from orb_slam3_rgbl_tpu_torch.viz.viewer import plot_map

        plot_map(slam.map, trajectory=slam.trajectory(), path=args.viz)
    return slam, results, times


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
