"""KITTI odometry loader (counterpart of ``orb_slam3_rgbl_tpu.io.kitti``;
reference ``Examples/RGB-L/rgbl_kitti.cc``: ``LoadImages``,
``LoadPointcloudBinaryMat``).

Layout (standard KITTI odometry):
    sequence_dir/
        times.txt
        calib.txt          (P0..P3, Tr)
        image_0/ image_2/  *.png  (grayscale / color)
        velodyne/          *.bin  (float32 x, y, z, reflectance)

Numpy only; images decode through the port's own PNG reader
(``io/png.py``), bit-identical to ``cv2.imread(path, IMREAD_GRAYSCALE)``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from orb_slam3_rgbl_tpu_torch.io import png


def load_times(seq_dir: str) -> np.ndarray:
    return np.loadtxt(os.path.join(seq_dir, "times.txt"), dtype=np.float64).reshape(-1)


def list_images(seq_dir: str, camera: str = "image_2") -> List[str]:
    d = os.path.join(seq_dir, camera)
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".png")]


def list_velodyne(seq_dir: str) -> List[str]:
    d = os.path.join(seq_dir, "velodyne")
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".bin")]


def load_pointcloud(path: str, max_points: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Velodyne .bin → ((N, 4) float32 xyzr, (N,) valid mask). With
    ``max_points`` the cloud is padded or truncated to that many points;
    truncation keeps the nearest (``argpartition`` on the squared range, as
    the JAX loader does: the far tail carries no depth under max_dist)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    if max_points is None:
        return raw, np.ones(len(raw), bool)
    n = len(raw)
    if n > max_points:
        d2 = np.einsum("ij,ij->i", raw[:, :3], raw[:, :3])
        keep = np.argpartition(d2, max_points - 1)[:max_points]
        return raw[keep], np.ones(max_points, bool)
    out = np.zeros((max_points, 4), np.float32)
    out[:n] = raw
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    return out, mask


def load_image_gray(path: str) -> np.ndarray:
    """(H, W) float32 gray image (``cv2.IMREAD_GRAYSCALE`` semantics)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return png.load_gray(path).astype(np.float32)


def load_calib(seq_dir: str) -> dict:
    """calib.txt → {'P0'..'P3': (3, 4), 'Tr': (3, 4)} (float64)."""
    out = {}
    with open(os.path.join(seq_dir, "calib.txt")) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.array(vals.split(), dtype=np.float64)
            if arr.size == 12:
                out[key.strip()] = arr.reshape(3, 4)
    return out


class KittiSequence:
    """Frames of a sequence as (gray image, pointcloud, mask, timestamp)."""

    def __init__(self, seq_dir: str, camera: str = "image_2", max_points: int = 131072):
        self.seq_dir = seq_dir
        self.times = load_times(seq_dir)
        self.images = list_images(seq_dir, camera)
        self.clouds = (list_velodyne(seq_dir)
                       if os.path.isdir(os.path.join(seq_dir, "velodyne")) else [])
        self.max_points = max_points
        self.calib = (load_calib(seq_dir)
                      if os.path.exists(os.path.join(seq_dir, "calib.txt")) else {})

    def __len__(self):
        return len(self.images)

    def frame(self, i: int):
        img = load_image_gray(self.images[i])
        if self.clouds:
            pcd, mask = load_pointcloud(self.clouds[i], self.max_points)
        else:
            pcd, mask = None, None
        return img, pcd, mask, float(self.times[i])
