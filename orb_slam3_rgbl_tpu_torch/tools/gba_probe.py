"""Offline global-BA probe (counterpart of the root ``tools/gba_probe.py``):
load a map saved by ``utils/serialization.save_map`` (the JAX package's
format; either package's map loads) with its ground truth beside it
(``<map>.gt.npz`` holding ``traj``, the frames' Twc rows), run the
whole-map solve as the loop closer does — ``ba_assembly.build_full_problem``
with the closer's tiers (from 1, not the JAX tool's 256 poses and 8,192
landmarks: the next power of two at most), 3 × 2 LM
iterations of ``optim/global_ba.global_bundle_adjust`` — and print the
keyframes' ATE against the ground truth and the reprojection error before
and after: does the global BA warp the map?

    python -m orb_slam3_rgbl_tpu_torch.tools.gba_probe <map.npz> [--device cuda|cpu]

The map is taken as made with the KITTI RGB-L settings (``kitti_rgbl_config``:
its camera and ORB scale pyramid), as the JAX tool takes it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

ROUNDS, ITERS_PER_ROUND = 3, 2


def kf_ate(m, valid, gt_traj, poses=None) -> float:
    """Rigidly aligned RMSE of the keyframe centres (from ``poses``, default
    the map's Tcw) against the ground-truth centres, both relative to the
    first frame."""
    from orb_slam3_rgbl_tpu_torch.geometry import align, lie

    est_c = lie.np_se3_centers((m.kf_pose if poses is None else poses)[valid])
    fids = m.kf_frame_id[valid].astype(int)
    gt_c = gt_traj[fids, 4:7] - gt_traj[0, 4:7]
    return float(align.ate_rmse(torch.as_tensor(est_c, dtype=torch.float32),
                                torch.as_tensor(gt_c, dtype=torch.float32)))


def run(path: str, device) -> dict:
    """Print the probe's lines; return its numbers unrounded."""
    from orb_slam3_rgbl_tpu_torch.config import kitti_rgbl_config
    from orb_slam3_rgbl_tpu_torch.optim import global_ba
    from orb_slam3_rgbl_tpu_torch.slam import ba_assembly
    from orb_slam3_rgbl_tpu_torch.slam import map_state as ms
    from orb_slam3_rgbl_tpu_torch.slam.frame import inv_scale_sigma2
    from orb_slam3_rgbl_tpu_torch.utils import serialization

    cfg = kitti_rgbl_config()
    m = serialization.load_map(path)
    gt = np.load(path + ".gt.npz")["traj"]
    valid = m.valid_kf_ids()
    out = {"n_kf": int(valid.size), "n_lm": int(m.lm_valid.sum()),
           "binding_issues": ms.check_binding_consistency(m),
           "reproj_before": ms.debug_reprojection_error(m, cfg.camera),
           "ate_before": kf_ate(m, valid, gt), "rounds": []}
    print(f"map: {out['n_kf']} KFs, {out['n_lm']} landmarks")
    print("binding issues:", out["binding_issues"])
    print("reproj before:", out["reproj_before"])
    print(f"KF ATE before GBA: {out['ate_before']:.3f} m")

    inv_s2 = inv_scale_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor, device="cpu").numpy()
    problem, window, lm_ids, _, _ = ba_assembly.build_full_problem(
        m, inv_s2, min_pose_tier=1, min_lm_tier=1, device=device)
    segments = global_ba.PoseSegments(problem.obs_kf, problem.obs_mask, problem.poses.shape[0])
    out["n_obs"] = int(problem.obs_mask.sum())
    print(f"problem: {len(window)} poses, {len(lm_ids)} landmarks, {out['n_obs']} observations, "
          f"{getattr(m, 'last_dropped_obs', 0)} dropped beyond cap")
    poses, lms = problem.poses, problem.landmarks
    for it in range(ROUNDS):
        res = global_ba.global_bundle_adjust(problem._replace(poses=poses, landmarks=lms),
                                             cfg.camera, segments, iterations=ITERS_PER_ROUND)
        poses, lms = res.poses, res.landmarks
        pose_now = m.kf_pose.copy()
        pose_now[window] = poses.cpu().numpy().astype(np.float32)[: len(window)]
        err, cost = kf_ate(m, valid, gt, pose_now), float(res.cost)
        out["rounds"].append({"iterations": ITERS_PER_ROUND * (it + 1), "ate": err, "cost": cost})
        print(f"after {ITERS_PER_ROUND * (it + 1)} LM iters: KF ATE {err:.3f} m, cost {cost:.1f}")
    # write the solve back and measure the reprojection after it
    m.kf_pose[window] = poses.cpu().numpy().astype(np.float32)[: len(window)]
    ok = m.lm_valid[lm_ids]
    m.lm_pos[lm_ids[ok]] = lms.cpu().numpy().astype(np.float32)[: len(lm_ids)][ok]
    out["reproj_after"] = ms.debug_reprojection_error(m, cfg.camera)
    print("reproj after:", out["reproj_after"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("map", help="a map saved by save_map, with <map>.gt.npz beside it")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from orb_slam3_rgbl_tpu_torch.device import resolve

    return run(args.map, resolve(args.device))


if __name__ == "__main__":
    main()
