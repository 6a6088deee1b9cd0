"""KITTI sequence publisher (counterpart of the root ``tools/kitti_publisher.py``;
the reference's ``ros2/kitti_odometry_publisher``): replays a KITTI odometry
sequence as timestamped image and point-cloud streams into an
``io.online.OnlineSlamNode`` at real time or another rate. The "topics"
are the node's ``feed_rgb`` / ``feed_cloud``, which is what the reference's
subscriber callbacks forward into (``rgbd-slam-node.cpp:52``).

    python -m orb_slam3_rgbl_tpu_torch.tools.kitti_publisher <settings.yaml> \\
        <sequence_dir> [--rate 1.0] [--frames N] [--out traj.txt] [--device cuda|cpu]

``--rate 1`` plays at the sequence's own pace (KITTI: 10 Hz); a node slower
than that drops its oldest queued frames. ``--rate 0`` streams as fast as
the files decode. The frames decode ahead in worker processes
(``io/native_loader``): decoding a PNG in the feeding thread would hold the
interpreter lock that the node's tracking thread needs.
"""

from __future__ import annotations

import argparse
import sys
import time


# decoder processes: an RGB PNG of KITTI's size takes ~0.2 s to decode on
# the card's host, so three keep ahead of KITTI's 10 Hz
DECODERS = 3


def publish(seq_dir: str, node, rate: float = 1.0, frames: int = 0,
            log=lambda *a: print(*a, file=sys.stderr)) -> int:
    """Stream the sequence into ``node`` at ``times.txt``'s pace over
    ``rate`` (rate > 1 plays faster; rate <= 0 as fast as possible).
    Returns the number of frames published."""
    from orb_slam3_rgbl_tpu_torch.io.native_loader import NativeKittiSequence

    with NativeKittiSequence(seq_dir, n_threads=DECODERS) as seq:
        n = len(seq) if frames <= 0 else min(frames, len(seq))
        t_start = time.perf_counter()
        for i in range(n):
            if rate > 0:
                delay = t_start + float(seq.times[i]) / rate - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            gray, cloud, _mask, t = seq.next_frame()
            node.feed_rgb(t, gray)
            if cloud is not None:
                node.feed_cloud(t, cloud)
            if i and i % 50 == 0:
                log(f"published {i}/{n} frames")
    return n


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="playback speed multiple (0 = as fast as possible)")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Publish the sequence into an RGB-L node on a fresh ``System``; save
    the trajectory. Returns the counts: published, tracked, dropped."""
    from orb_slam3_rgbl_tpu_torch.config import RGBL, load_config
    from orb_slam3_rgbl_tpu_torch.io.online import OnlineSlamNode
    from orb_slam3_rgbl_tpu_torch.slam.system import System

    system = System(load_config(args.settings, sensor=RGBL), device=args.device)
    poses = []
    node = OnlineSlamNode(system, mode="rgbl", on_pose=lambda t, r: poses.append((t, r)))
    n = publish(args.sequence, node, rate=args.rate, frames=args.frames)
    node.stop()
    system.shutdown()
    system.save_trajectory_kitti(args.out)
    out = {"published": n, "tracked": len(poses), "dropped": node.dropped_frames}
    print(f"published {n} frames, tracked {len(poses)}, dropped {node.dropped_frames}; "
          f"trajectory -> {args.out}", file=sys.stderr)
    return out


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
