"""Host-side IMU frontend: sample buffering and preintegration of the
buffered samples (counterpart of ``orb_slam3_rgbl_tpu.slam.imu_frontend``;
the reference's ``GrabImuData`` queue and ``PreintegrateIMU`` between frames,
``Tracking.cc:1652-1760``).

The JAX package pads a window to a power-of-two tier so that XLA compiles
a handful of shapes; the port hands ``preintegrate`` the real samples.
Sample timestamps stay float64 on the host until the intervals are taken
(EuRoC stamps are ~1.4e9 s: float32 would lose the 5 ms intervals); the
intervals, accelerations and rates go to the device as float32.
Preintegrations are stored on the host as 12 numpy arrays
(``preint_to_numpy``), the layout of the JAX package's ``MapState.imu_preint``
and of both packages' archives; one ``(n, 143)`` upload brings a batch of
them back (``stack_preints``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.config import SlamConfig
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.imu import preintegration as pre

# (name, shape) of the 12 host arrays of a preintegration, in order
PREINT_LAYOUT = (("dt", ()), ("dR", (4,)), ("dV", (3,)), ("dP", (3,)), ("JRg", (3, 3)),
                 ("JVg", (3, 3)), ("JVa", (3, 3)), ("JPg", (3, 3)), ("JPa", (3, 3)),
                 ("cov", (9, 9)), ("bg", (3,)), ("ba", (3,)))
PREINT_WIDTH = sum(int(np.prod(s)) for _, s in PREINT_LAYOUT)   # 143


def body_cam_extrinsics(cfg: SlamConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(T_bc, T_cb) as (7,) SE3 from the 4×4 row-major ``IMU.T_b_c1``
    calibration (camera → body, the reference's ``Calib::Tbc``). An
    inertial configuration without ``cfg.imu`` is refused."""
    if cfg.imu is None:
        raise ValueError("an inertial sensor needs cfg.imu (ImuConfig)")
    return extrinsics(cfg.imu)


def extrinsics(imu_cfg) -> Tuple[np.ndarray, np.ndarray]:
    """(T_bc, T_cb) of an ``ImuConfig`` (``body_cam_extrinsics``)."""
    M = torch.as_tensor(np.asarray(imu_cfg.T_body_cam, np.float32).reshape(4, 4))
    T_bc = lie.se3_from_matrix(M).numpy().astype(np.float32)
    return T_bc, lie.np_se3_inv(T_bc).astype(np.float32)


def sample_intervals(t: np.ndarray) -> np.ndarray:
    """Per-sample integration intervals from the sample times: each
    sample's interval is the following one, the last sample repeats the
    one before it (the reference's trapezoid bookkeeping to first order)."""
    t = np.asarray(t, np.float64)
    dts = np.zeros(t.size, np.float32)
    if t.size >= 2:
        d = np.diff(t).astype(np.float32)
        dts[:-1] = d
        dts[-1] = d[-1]
    return dts


def _upload(samples: np.ndarray, device):
    """(S, 7) host samples → (acc (S, 3), gyro (S, 3), intervals (S,)) on
    ``device``, one upload."""
    samples = np.asarray(samples, np.float64)
    block = np.concatenate([samples[:, 1:7].astype(np.float32),
                            sample_intervals(samples[:, 0])[:, None]], axis=1)
    dev = torch.as_tensor(block, device=device)
    return dev[:, 0:3], dev[:, 3:6], dev[:, 6]


def _device_bias(bias: pre.ImuBias, device) -> pre.ImuBias:
    return pre.ImuBias(torch.as_tensor(np.asarray(bias.bg, np.float32), device=device),
                       torch.as_tensor(np.asarray(bias.ba, np.float32), device=device))


def preintegrate_samples(samples: np.ndarray, bias: pre.ImuBias, noise_acc: float,
                         noise_gyro: float, device) -> pre.Preintegrated:
    """Preintegrate an (S, 7) ``[t, ax ay az, gx gy gz]`` sample block on
    ``device``; ``bias`` holds host arrays or tensors."""
    acc, gyr, dts = _upload(samples, device)
    return pre.preintegrate(acc, gyr, dts, _device_bias(bias, device), noise_acc=noise_acc,
                            noise_gyro=noise_gyro)


class ImuAccumulator:
    """Samples since the last keyframe (or frame), preintegrated on demand
    at the bias asked for (``Preintegrated::Reintegrate``). Integration is
    incremental while the bias stays: the integration of all samples but the
    last (whose interval the next sample fixes) is kept, and only the newer
    samples are integrated on top of it, the operations and their order
    unchanged. The last result is kept too: the same samples at the same
    bias are not integrated again within a frame."""

    def __init__(self, cfg: SlamConfig, device):
        self.cfg = cfg
        self.device = device
        self.samples: List[np.ndarray] = []
        self._memo = None      # (n, bias bytes, Preintegrated of all n)
        self._partial = None   # (n − 1, bias bytes, Preintegrated of the first n − 1)

    def add(self, block: Optional[np.ndarray]):
        if block is not None and len(block):
            self.samples.append(np.asarray(block, np.float64).reshape(-1, 7))

    def reset(self):
        self.samples = []
        self._memo = self._partial = None

    @property
    def n(self) -> int:
        return sum(len(s) for s in self.samples)

    def preintegrate(self, bias: pre.ImuBias) -> Optional[pre.Preintegrated]:
        """The buffered samples at the host bias ``bias`` (numpy arrays);
        None under two samples."""
        n = self.n
        if n < 2:
            return None
        key = np.asarray(bias.bg, np.float32).tobytes() + np.asarray(bias.ba, np.float32).tobytes()
        if self._memo is not None and self._memo[:2] == (n, key):
            return self._memo[2]
        block = np.concatenate(self.samples, axis=0)
        acc, gyr, dts = _upload(block, self.device)
        kw = dict(noise_acc=self.cfg.imu.noise_acc, noise_gyro=self.cfg.imu.noise_gyro)
        start, done = None, 0
        if self._partial is not None and self._partial[1] == key and self._partial[0] < n:
            done, _, start = self._partial
        b = start.bias0 if start is not None else _device_bias(bias, self.device)
        # the first n − 1 samples, kept for the next call, then the last one
        part = pre.preintegrate(acc[done:n - 1], gyr[done:n - 1], dts[done:n - 1], b,
                                start=start, **kw)
        out = pre.preintegrate(acc[n - 1:], gyr[n - 1:], dts[n - 1:], b, start=part, **kw)
        self._partial = (n - 1, key, part)
        self._memo = (n, key, out)
        return out


def _flat(p: pre.Preintegrated) -> torch.Tensor:
    parts = (p.dt, p.dR, p.dV, p.dP, p.JRg, p.JVg, p.JVa, p.JPg, p.JPa, p.cov,
             p.bias0.bg, p.bias0.ba)
    return torch.cat([x.reshape(-1) for x in parts])


def preint_to_numpy(p: pre.Preintegrated) -> tuple:
    """The 12 host arrays of a preintegration (one download)."""
    v = _flat(p).detach().cpu().numpy().astype(np.float32)
    out, i = [], 0
    for _, shape in PREINT_LAYOUT:
        n = int(np.prod(shape))
        out.append(v[i:i + n].reshape(shape).copy())
        i += n
    return tuple(out)


def zero_preint_numpy() -> tuple:
    """The preintegration of no motion (identity deltas, no covariance, no
    time): the placeholder of a pair without a chain link."""
    out = [np.zeros(shape, np.float32) for _, shape in PREINT_LAYOUT]
    out[1][0] = 1.0
    return tuple(out)


def _unflat(v: torch.Tensor) -> pre.Preintegrated:
    lead = v.shape[:-1]
    parts, i = [], 0
    for _, shape in PREINT_LAYOUT:
        n = int(np.prod(shape))
        parts.append(v[..., i:i + n].reshape(lead + shape))
        i += n
    return pre.Preintegrated(*parts[:10], bias0=pre.ImuBias(parts[10], parts[11]))


def stack_preints(ts, device) -> pre.Preintegrated:
    """A batch (axis 0) of host preintegration tuples on ``device``, from
    one upload."""
    flat = np.zeros((len(ts), PREINT_WIDTH), np.float32)
    for i, t in enumerate(ts):
        flat[i] = np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in t])
    return _unflat(torch.as_tensor(flat, device=device))


def preint_from_numpy(t, device) -> pre.Preintegrated:
    """One host preintegration tuple on ``device``."""
    return _unflat(torch.as_tensor(
        np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in t]), device=device))
