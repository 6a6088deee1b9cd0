"""ATE evaluation (counterpart of ``evaluation/evaluate_ate.py``; the
reference's ``evaluation/evaluate_ate_scale.py``): Horn alignment of an
estimated KITTI-format trajectory onto the ground truth, optionally with
scale, and the RMSE of the aligned positions.

    python -m orb_slam3_rgbl_tpu_torch.tools.evaluate_ate <gt_poses.txt> \\
        <est_poses.txt> [--scale] [--rpe-delta N] [--device cuda|cpu]

Prints ``frames``, ``ate_rmse_m``, with ``--scale`` the ``scale`` and with
``--rpe-delta N`` the translational RPE at that frame delta, one a line.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("gt")
    ap.add_argument("est")
    ap.add_argument("--scale", action="store_true", help="align with Sim3 (monocular)")
    ap.add_argument("--rpe-delta", type=int, default=0,
                    help="also print RPE at this frame delta")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The numbers the tool prints, by their printed names."""
    from orb_slam3_rgbl_tpu_torch.device import resolve
    from orb_slam3_rgbl_tpu_torch.geometry import align
    from orb_slam3_rgbl_tpu_torch.io.trajectory import load_kitti_poses

    device = resolve(args.device)
    gt = load_kitti_poses(args.gt)
    est = load_kitti_poses(args.est)
    n = min(len(gt), len(est))
    gt = torch.as_tensor(gt[:n], device=device)
    est = torch.as_tensor(est[:n], device=device)
    a = align.horn_align(est[:, 4:7], gt[:, 4:7], with_scale=args.scale)
    out = {"frames": n, "ate_rmse_m": float(a.rmse)}
    if args.scale:
        out["scale"] = float(a.s)
    if args.rpe_delta > 0:
        out[f"rpe_trans_m@{args.rpe_delta}"] = float(
            align.rpe_translation(gt, est, delta=args.rpe_delta))
    print(f"frames: {n}")
    for key, value in list(out.items())[1:]:
        print(f"{key}: {value:.6f}")
    return out


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
