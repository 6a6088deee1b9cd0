"""EuRoC / TUM-VI driver (counterpart of ``examples/run_euroc.py``; the
reference's ``mono_euroc`` and ``stereo_euroc`` examples): an ASL-format
sequence in, the per-frame tracking time (median and mean) printed, TUM and
EuRoC-format trajectories out.

    python -m orb_slam3_rgbl_tpu_torch.examples.run_euroc <settings.yaml> <mav_dir> \\
        [--mode mono|stereo|mono-inertial|stereo-inertial] [--timestamps EuRoC_TimeStamps/MH01.txt] \\
        [--frames N] [--out-tum f_dataset.txt] [--out-kf kf_dataset.txt] [--device cuda|cpu]

The inertial modes (the reference's ``mono_inertial_euroc`` and
``stereo_inertial_euroc``) read ``imu0/data.csv`` and hand each frame the
samples since the previous one (``EurocSequence(..., inertial=True)``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

MODES = {
    "mono": ("MONOCULAR", False, False),
    "stereo": ("STEREO", True, False),
    "mono-inertial": ("IMU_MONOCULAR", False, True),
    "stereo-inertial": ("IMU_STEREO", True, True),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings")
    ap.add_argument("mav_dir")
    ap.add_argument("--mode", default="mono", choices=sorted(MODES))
    ap.add_argument("--timestamps", default="")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--out-tum", default="f_dataset.txt")
    ap.add_argument("--out-kf", default="kf_dataset.txt")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """Track the sequence; returns (System, per-frame TrackResults, per-frame
    host seconds). A frame's time ends when the System's stream has
    finished its work."""
    from orb_slam3_rgbl_tpu_torch import config as cfg_mod
    from orb_slam3_rgbl_tpu_torch.io.euroc import EurocSequence
    from orb_slam3_rgbl_tpu_torch.slam.system import System

    sensor_name, stereo, inertial = MODES[args.mode]
    cfg = cfg_mod.load_config(args.settings, sensor=getattr(cfg_mod, sensor_name))
    slam = System(cfg, device=args.device)

    seq = EurocSequence(args.mav_dir, stereo=stereo, inertial=inertial,
                        timestamps_file=args.timestamps or None)
    n = len(seq) if args.frames <= 0 else min(args.frames, len(seq))

    results, times = [], []
    for i in range(n):
        fr = seq.frame(i)
        t0 = time.perf_counter()
        if stereo:
            im_l, im_r, imu, t = fr
            res = slam.track_stereo(im_l, im_r, t, imu=imu)
        else:
            img, imu, t = fr
            res = slam.track_monocular(img, t, imu=imu)
        if slam.device.type == "cuda":
            torch.cuda.current_stream(slam.device).synchronize()
        results.append(res)
        times.append(time.perf_counter() - t0)
        if i % 100 == 0:
            print(f"[{i}/{n}] state={res.state} inliers={res.n_inliers}", file=sys.stderr)

    arr = np.asarray(times)
    print(f"median tracking time: {np.median(arr):.4f}", file=sys.stderr)
    print(f"mean tracking time: {arr.mean():.4f}", file=sys.stderr)
    slam.save_trajectory_tum(args.out_tum)
    slam.save_keyframe_trajectory_tum(args.out_kf)
    slam.save_trajectory_euroc(args.out_tum.replace(".txt", "_euroc.txt"))
    print(f"trajectories saved to {args.out_tum} / {args.out_kf}", file=sys.stderr)
    return slam, results, times


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
