"""Offline LiDAR → depth-map generator (counterpart of the root
``tools/project_velodyne.py``; the reference's
``tools/proj_velo2cam_kitti_odom.py`` and ``ros2/depth_map_creator``), on the
port's own projection and upsamplers, so that the PNGs hold what the online
RGB-L path computes.

Reads a KITTI odometry sequence (``calib.txt``'s P2 · Tr), projects every
``velodyne/*.bin`` into the image (its size from the first ``image_2`` PNG's
header), optionally densifies, and writes 16-bit depth PNGs (metres =
value / factor) for the RGB-D driver (``examples/run_kitti_rgbd.py``).

    python -m orb_slam3_rgbl_tpu_torch.tools.project_velodyne <sequence_dir> \\
        [--out-dir depth] [--method None|InverseDilation|AverageFiltering] \\
        [--factor 256] [--frames N] [--min-dist 5] [--max-dist 200] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

METHODS = ("None", "InverseDilation", "AverageFiltering")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sequence")
    ap.add_argument("--out-dir", default="depth")
    ap.add_argument("--method", default="None", choices=METHODS)
    ap.add_argument("--factor", type=float, default=256.0,
                    help="png value = depth * factor (KITTI's depth convention)")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--min-dist", type=float, default=5.0)
    ap.add_argument("--max-dist", type=float, default=200.0)
    ap.add_argument("--camera", default="P2", help="calib projection to use")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def projection(seq_dir: str, camera: str = "P2") -> np.ndarray:
    """(3, 4) float32 P_cam · [Tr; 0 0 0 1] of ``calib.txt`` (the reference
    tool's composition)."""
    from orb_slam3_rgbl_tpu_torch.io import kitti

    calib = kitti.load_calib(seq_dir)
    Tr44 = np.eye(4)
    Tr44[:3, :] = calib["Tr"]
    return (calib[camera] @ Tr44).astype(np.float32)


def depth_png(pts: np.ndarray, mask: np.ndarray, P: np.ndarray, height: int, width: int,
              method: str, factor: float, min_dist: float, max_dist: float,
              device) -> np.ndarray:
    """One cloud → its (height, width) uint16 depth PNG samples."""
    from orb_slam3_rgbl_tpu_torch.ops import depth as depth_ops

    raw = depth_ops.project_pointcloud(
        torch.as_tensor(pts, device=device), torch.as_tensor(P, device=device), height, width,
        min_dist, max_dist, torch.as_tensor(mask, device=device))
    if method == "InverseDilation":
        dense = depth_ops.upsample_inverse_dilation(raw, max_dist, "Diamond", 5, 7)
    elif method == "AverageFiltering":
        dense = depth_ops.upsample_average_filtering(raw, 5, True, "Diamond", 3, max_dist)
    else:
        dense = raw
    return np.clip(dense.cpu().numpy() * factor, 0, 65535).astype(np.uint16)


def run(args: argparse.Namespace) -> list:
    """Write the depth PNGs; returns their paths."""
    from orb_slam3_rgbl_tpu_torch.device import resolve
    from orb_slam3_rgbl_tpu_torch.io import kitti, png

    device = resolve(args.device)
    P = projection(args.sequence, args.camera)
    images = kitti.list_images(args.sequence)
    clouds = kitti.list_velodyne(args.sequence)
    if not images or not clouds:
        raise SystemExit(f"{args.sequence}: no image_2/*.png or velodyne/*.bin")
    height, width = png.image_size(images[0])
    out_dir = os.path.join(args.sequence, args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    n = min(len(images), len(clouds))
    if args.frames > 0:
        n = min(n, args.frames)
    paths = []
    for i in range(n):
        pts, mask = kitti.load_pointcloud(clouds[i], max_points=131072)
        d16 = depth_png(pts, mask, P, height, width, args.method, args.factor,
                        args.min_dist, args.max_dist, device)
        name = os.path.splitext(os.path.basename(clouds[i]))[0] + ".png"
        paths.append(os.path.join(out_dir, name))
        png.write_png(paths[-1], d16)
        if i % 100 == 0:
            print(f"[{i}/{n}] {name}", file=sys.stderr)
    print(f"wrote {n} depth maps to {out_dir}", file=sys.stderr)
    return paths


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
