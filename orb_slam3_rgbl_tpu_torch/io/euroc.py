"""EuRoC MAV / TUM-VI and TUM RGB-D loaders (counterpart of
``orb_slam3_rgbl_tpu.io.euroc``; the reference drivers' ``LoadImages`` /
``LoadIMU`` of ``Examples/Monocular{,-Inertial}/`` and ``rgbd_tum``):
images indexed by a timestamp file, IMU samples from ``imu0/data.csv``,
grouped per frame interval the way the reference fills ``vImuMeas``
between consecutive images.

EuRoC layout (ASL format, also used by TUM-VI):
    mav0/
        cam0/data.csv  cam0/data/<ts>.png
        cam1/data.csv  cam1/data/<ts>.png
        imu0/data.csv  (ts[ns], wx, wy, wz, ax, ay, az)

Numpy only; images decode through the port's own PNG reader
(``io/png.py``), bit-identical to ``cv2.imread``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from orb_slam3_rgbl_tpu_torch.io import png


def _gray(path: str) -> np.ndarray:
    """(H, W) float32 gray image (``cv2.IMREAD_GRAYSCALE`` semantics)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return png.load_gray(path).astype(np.float32)


def _read_csv(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", comments="#", usecols=None, ndmin=2)


def load_cam_index(mav_dir: str, cam: str = "cam0") -> Tuple[np.ndarray, List[str]]:
    """(timestamps [s], image paths) for one camera."""
    csv = os.path.join(mav_dir, cam, "data.csv")
    ts: List[float] = []
    paths: List[str] = []
    with open(csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            ts.append(int(parts[0]) * 1e-9)
            paths.append(os.path.join(mav_dir, cam, "data", parts[1].strip()))
    return np.asarray(ts, np.float64), paths


def load_imu(mav_dir: str, imu: str = "imu0") -> np.ndarray:
    """imu0/data.csv → (S, 7) float64 ``[t, ax, ay, az, gx, gy, gz]``
    (the sample layout the tracker's ``imu=`` argument expects; the CSV
    stores gyro first — columns are swapped here)."""
    raw = _read_csv(os.path.join(mav_dir, imu, "data.csv"))
    out = np.empty((len(raw), 7), np.float64)
    out[:, 0] = raw[:, 0] * 1e-9
    out[:, 1:4] = raw[:, 4:7]  # accel
    out[:, 4:7] = raw[:, 1:4]  # gyro
    return out


class EurocSequence:
    """Iterable over (gray[, gray_right], imu_window, timestamp).

    ``imu_window`` for frame i holds all samples with
    t ∈ (t_{i-1}, t_i] — the reference accumulates exactly this window
    into ``vImuMeas`` before each ``Track*`` call."""

    def __init__(self, mav_dir: str, stereo: bool = False, inertial: bool = False,
                 timestamps_file: Optional[str] = None):
        # allow passing the dataset root (containing mav0/)
        if os.path.isdir(os.path.join(mav_dir, "mav0")):
            mav_dir = os.path.join(mav_dir, "mav0")
        self.mav_dir = mav_dir
        self.stereo = stereo
        self.inertial = inertial
        self.times, self.left = load_cam_index(mav_dir, "cam0")
        self.right: List[str] = []
        if stereo:
            t1, self.right = load_cam_index(mav_dir, "cam1")
            n = min(len(self.left), len(self.right))
            self.times, self.left, self.right = self.times[:n], self.left[:n], self.right[:n]
        if timestamps_file:
            # reference-style external timestamp list (EuRoC_TimeStamps/*.txt, ns)
            want = np.loadtxt(timestamps_file, dtype=np.int64).reshape(-1) * 1e-9
            idx = np.searchsorted(self.times, want)
            inb = idx < len(self.times)
            idx, want = idx[inb], want[inb]
            # drop entries absent from cam0/data.csv instead of silently
            # selecting the next frame at the insertion index (timestamps
            # match to ~1 µs; EuRoC stamps are exact ns integers)
            keep = idx[np.abs(self.times[idx] - want) < 1e-6]
            self.times = self.times[keep]
            self.left = [self.left[i] for i in keep]
            if self.right:
                self.right = [self.right[i] for i in keep]
        self.imu = load_imu(mav_dir) if inertial else np.zeros((0, 7))
        self._imu_cursor = 0

    def __len__(self):
        return len(self.left)

    def imu_window(self, i: int) -> Optional[np.ndarray]:
        if not self.inertial:
            return None
        t_hi = self.times[i]
        t_lo = self.times[i - 1] if i > 0 else -np.inf
        t = self.imu[:, 0]
        sel = (t > t_lo) & (t <= t_hi)
        # float64: a float32 EuRoC stamp (~1.4e9 s) is 128 s coarse
        return self.imu[sel].copy()

    def frame(self, i: int):
        out = [_gray(self.left[i])]
        if self.stereo:
            out.append(_gray(self.right[i]))
        return (*out, self.imu_window(i), float(self.times[i]))


class TumRgbdSequence:
    """TUM RGB-D: rgb.txt / depth.txt (timestamp path per line), depth
    PNGs scaled by 5000 (the dataset's DepthMapFactor). Association by
    nearest timestamp (≡ ``evaluation/associate.py`` semantics)."""

    def __init__(self, seq_dir: str, max_dt: float = 0.02, depth_factor: float = 5000.0):
        self.seq_dir = seq_dir
        self.depth_factor = depth_factor
        rgb = self._read_list(os.path.join(seq_dir, "rgb.txt"))
        dep = self._read_list(os.path.join(seq_dir, "depth.txt"))
        dts = np.asarray([t for t, _ in dep])
        self.frames = []
        for t, p in rgb:
            j = int(np.argmin(np.abs(dts - t)))
            if abs(dts[j] - t) <= max_dt:
                self.frames.append((t, p, dep[j][1]))

    @staticmethod
    def _read_list(path: str):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, p = line.split()[:2]
                out.append((float(t), p))
        return out

    def __len__(self):
        return len(self.frames)

    def frame(self, i: int):
        t, rgb_p, dep_p = self.frames[i]
        img = _gray(os.path.join(self.seq_dir, rgb_p))
        dep_p = os.path.join(self.seq_dir, dep_p)
        if not os.path.exists(dep_p):
            raise FileNotFoundError(dep_p)
        depth = png.read_png(dep_p).astype(np.float32) / self.depth_factor
        return img, depth, None, t
