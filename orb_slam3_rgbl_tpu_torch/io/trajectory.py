"""Trajectory writers in the reference output formats (counterpart of
``orb_slam3_rgbl_tpu.io.trajectory``).

* KITTI: one 3×4 row-major ``Twc`` matrix per line
  (``System::SaveTrajectoryKITTI``).
* TUM: ``timestamp tx ty tz qx qy qz qw`` (``System::SaveTrajectoryTUM``).
* EuRoC: ``timestamp_ns tx ty tz qx qy qz qw``
  (``System::SaveTrajectoryEuRoC``).

Poses are (F, 7) ``[qw, qx, qy, qz, tx, ty, tz]`` numpy arrays; the
matrix conversions run on the CPU in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie


def save_kitti(path: str, poses_twc: np.ndarray):
    """(F, 7) world-frame SE3 → KITTI 3×4 text rows."""
    M = lie.se3_to_matrix(torch.as_tensor(np.asarray(poses_twc, np.float32))).numpy()
    with open(path, "w") as f:
        for m in M:
            f.write(" ".join(f"{x:.9e}" for x in m[:3, :].reshape(-1)) + "\n")


def save_tum(path: str, timestamps, poses_twc: np.ndarray):
    with open(path, "w") as f:
        for t, T in zip(timestamps, poses_twc):
            qw, qx, qy, qz, tx, ty, tz = T
            f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} {qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")


def save_euroc(path: str, timestamps, poses_twc: np.ndarray):
    with open(path, "w") as f:
        for t, T in zip(timestamps, poses_twc):
            qw, qx, qy, qz, tx, ty, tz = T
            f.write(f"{t * 1e9:.6f} {tx:.9f} {ty:.9f} {tz:.9f}"
                    f" {qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f}\n")


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI ground-truth ``poses/XX.txt`` → (F, 7) SE3 Twc (float32)."""
    rows = np.loadtxt(path, ndmin=2).reshape(-1, 3, 4).astype(np.float32)
    return lie.se3_from_matrix(torch.from_numpy(rows)).numpy()
