"""Pose-graph correction probe (counterpart of the root ``tools/pg_probe.py``):
does ``optim/pose_graph.optimize_pose_graph`` relax a loop problem shaped
like the engine bench's?

``build`` makes the bench's keyframe graph synthetically: two laps of a
radius-22 circle, K nodes, odometry drift accumulating along the chain,
structural edges measured from the drifted estimates (what
``_essential_edges`` does) and a loop edge carrying the true relative Sim3
of a revisit pair. The probe prints the nodes' position error against the
ground truth before the solve and after 10, 20, 50 and 100 iterations.

    python -m orb_slam3_rgbl_tpu_torch.tools.pg_probe [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from orb_slam3_rgbl_tpu_torch.geometry import lie

ITERATIONS = (10, 20, 50, 100)


def _quat(R: np.ndarray) -> np.ndarray:
    return lie.matrix_to_quat(torch.as_tensor(R.astype(np.float32))).numpy()


def build(K: int = 64, radius: float = 22.0, laps: float = 2.0, drift_per_step: float = 0.04):
    """(ground-truth Tcw (K, 7), drifted Tcw (K, 7), Sim3 nodes (K, 8),
    edges (i, j, S_ij, weight), fixed-node mask), as numpy."""
    th = np.linspace(0, 2 * np.pi * laps, K, endpoint=False)
    centers = np.stack([radius * np.cos(th), np.zeros(K), radius * np.sin(th)], 1)
    gt = []
    for i in range(K):
        fwd = np.array([-np.sin(th[i]), 0.0, np.cos(th[i])])
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)            # right-handed: x × y = z
        Rwc = np.stack([right, down, fwd], 1)  # the camera's axes in the world
        gt.append(np.concatenate([_quat(Rwc.T), -Rwc.T @ centers[i]]).astype(np.float32))
    gt = np.stack(gt)
    # drifted estimates: node i turned about the start by i·dyaw, its centre
    # drifting linearly (the loop-less bench's ~2.5 m end drift)
    c0 = centers[0]
    est = []
    for i in range(K):
        a = 0.0012 * i
        dR = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]])
        Rwc = lie.quat_to_matrix(torch.as_tensor(gt[i][:4])).numpy().T
        Rwc_e = dR @ Rwc
        c_e = dR @ (centers[i] - c0) + c0 + i * np.asarray(
            [drift_per_step, 0.0, drift_per_step / 2])
        Rcw_e = Rwc_e.T
        est.append(np.concatenate([_quat(Rcw_e), (-Rcw_e @ c_e).astype(np.float32)])
                   .astype(np.float32))
    est = np.stack(est)

    nodes = np.concatenate([est, np.ones((K, 1), np.float32)], 1)
    # structural edges from the drifted estimates (chain + skip-2)
    ei, ej, Sij, w = [], [], [], []
    for i in range(1, K):
        for j in (i - 1, i - 2):
            if j < 0:
                continue
            ei.append(i)
            ej.append(j)
            Sij.append(lie.np_sim3_mul(nodes[i], lie.np_sim3_inv(nodes[j])))
            w.append(1.0)
    # the loop edge: the first revisit pair (i on lap 2, j on lap 1), true Sim3
    matched = int(K / laps) + 2
    loops = [(matched, 2)]
    gtn = np.concatenate([gt, np.ones((K, 1), np.float32)], 1)
    for a, b in loops:
        ei.append(a)
        ej.append(b)
        Sij.append(lie.np_sim3_mul(gtn[a], lie.np_sim3_inv(gtn[b])))
        w.append(10.0)
    fixed = np.zeros(K, bool)
    fixed[loops[0][1]] = True   # the matched (old) node holds
    return gt, est, nodes, (ei, ej, Sij, w), fixed


def solve(nodes, edges, fixed, iterations: int, device) -> np.ndarray:
    """The graph's (K, 8) Sim3 nodes after ``iterations`` of
    ``optimize_pose_graph`` with the scale fixed."""
    from orb_slam3_rgbl_tpu_torch.optim import pose_graph

    ei, ej, Sij, w = edges
    K, E = len(nodes), len(ei)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    prob = pose_graph.PoseGraphProblem(
        nodes=dev(nodes, torch.float32), node_fixed=dev(fixed, torch.bool),
        node_valid=torch.ones(K, dtype=torch.bool, device=device),
        edge_i=dev(ei, torch.int64), edge_j=dev(ej, torch.int64),
        edge_Sij=dev(np.stack(Sij), torch.float32), edge_weight=dev(w, torch.float32),
        edge_valid=torch.ones(E, dtype=torch.bool, device=device))
    return pose_graph.optimize_pose_graph(prob, iterations=iterations,
                                          fix_scale=True).cpu().numpy()


def err_vs_gt(poses, gt) -> np.ndarray:
    return np.linalg.norm(lie.np_se3_centers(poses) - lie.np_se3_centers(gt), axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from orb_slam3_rgbl_tpu_torch.device import resolve

    device = resolve(args.device)
    gt, est, nodes, edges, fixed = build()
    e0 = err_vs_gt(est, gt)
    print(f"before: mean {e0.mean():.3f} max {e0.max():.3f}")
    for iters in ITERATIONS:
        out = solve(nodes, edges, fixed, iters, device)
        e1 = err_vs_gt(lie.np_sim3_to_se3(out), gt)
        print(f"after {iters:3d} iters: mean {e1.mean():.3f} max {e1.max():.3f}")


if __name__ == "__main__":
    main()
