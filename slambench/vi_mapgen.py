"""Seeded generator of a stereo-inertial map at the moment a loop correction
hands it to the whole-map inertial bundle adjustment: ``mapgen``'s map of a
rig circling a hall (``hall_loops``), given a time base and an IMU.

numpy only, float64 throughout: it imports nothing of the program. One seed
gives one map, bit for bit.

* The keyframes are ``kf_dt_s`` apart on a continuous trajectory: the hall
  loop of ``mapgen.hall_trajectory`` with its angle a linear function of
  time, so that its keyframes fall where ``mapgen`` puts them (at
  ``speed_mps`` along the loop's mean radius, ``kf_spacing_m`` =
  ``speed_mps`` × ``kf_dt_s``).
* The world is re-expressed gravity-down, gravity (0, 0, −g), as an
  inertial map is after its IMU initialization: a rotation of ``mapgen``'s
  world (the first keyframe's camera, whose y axis is the hall's down).
* The body is the camera through the configuration's ``IMU.T_b_c1``
  (camera → body). At ``frequency_hz`` the IMU reads the body's angular
  rate and specific force (central differences of the body pose, h = 1 ms)
  plus a bias that starts from a seeded draw and walks (``gyro_walk`` /
  ``acc_walk`` × √dt a sample) and white noise (``noise_gyro`` /
  ``noise_acc`` × √rate a sample: EuRoC.yaml's densities).
* Each consecutive pair of keyframes is preintegrated over its samples
  (the reference's ``IMU::Preintegrated::IntegrateNewMeasurement``,
  ``ImuTypes.cc``) at the earlier keyframe's bias as the map holds it, and
  stored in the port's 143-value layout. Its covariance is the reference's:
  ``IMU::Calib`` takes a sample's deviation as the yaml's density × √rate
  (ORB-SLAM3 scales ``NoiseGyro`` and ``NoiseAcc`` by √freq before it
  preintegrates), the same deviation the samples' noise is drawn with.
* After the correction the map's velocities are off by ``vel_mps`` and
  its biases by a common ``bg_radps`` / ``ba_mps2`` (RMS over the axes),
  besides ``mapgen``'s pose and landmark errors.
"""

from __future__ import annotations

import numpy as np

from slambench import mapgen

# the 12 arrays of a preintegration, in the order of its 143 values
PREINT_LAYOUT = (("dt", ()), ("dR", (4,)), ("dV", (3,)), ("dP", (3,)), ("JRg", (3, 3)),
                 ("JVg", (3, 3)), ("JVa", (3, 3)), ("JPg", (3, 3)), ("JPa", (3, 3)),
                 ("cov", (9, 9)), ("bg", (3,)), ("ba", (3,)))
PREINT_WIDTH = 143


def hat(w: np.ndarray) -> np.ndarray:
    z = np.zeros(w.shape[:-1])
    x, y, v = w[..., 0], w[..., 1], w[..., 2]
    return np.stack([z, -v, y, v, z, -x, -y, x, z], -1).reshape(w.shape[:-1] + (3, 3))


def exp_so3(w: np.ndarray) -> np.ndarray:
    """(..., 3) rotation vectors → (..., 3, 3) matrices."""
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    W = hat(w)
    small = th < 1e-8
    safe = np.where(small, 1.0, th)
    a = np.where(small, 1.0 - th ** 2 / 6.0, np.sin(safe) / safe)
    b = np.where(small, 0.5 - th ** 2 / 24.0, (1.0 - np.cos(safe)) / safe ** 2)
    return np.eye(3) + a * W + b * (W @ W)


def log_so3(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotations (angle below π) → (..., 3) rotation vectors."""
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    v = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < 1e-8
    f = np.where(small, 0.5 + th ** 2 / 12.0, th / (2.0 * np.sin(np.where(small, 1.0, th))))
    return f[..., None] * v


def right_jacobian(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    W = hat(w)
    small = th < 1e-8
    safe = np.where(small, 1.0, th)
    b = np.where(small, 0.5 - th ** 2 / 24.0, (1.0 - np.cos(safe)) / safe ** 2)
    c = np.where(small, 1.0 / 6.0 - th ** 2 / 120.0, (safe - np.sin(safe)) / safe ** 3)
    return np.eye(3) - b * W + c * (W @ W)


def hall_pose(theta: np.ndarray, p: dict, ph: np.ndarray):
    """``mapgen.hall_trajectory``'s camera → world rotation and centre at
    loop angles ``theta`` (any shape), with its phases ``ph``."""
    r = p["radius_m"] + p["radius_var_m"] * np.sin(3 * theta + ph[1])
    y = p["height_var_m"] * np.sin(2 * theta + ph[2])
    centre = np.stack([r * np.cos(theta), y, r * np.sin(theta)], -1)
    yaw = np.radians(p["yaw_deg"]) * np.sin(5 * theta + ph[3])
    pitch = np.radians(p["pitch_deg"]) * np.sin(7 * theta + ph[1])
    return mapgen.rot_y(np.pi / 2 - theta + yaw) @ mapgen.rot_x(pitch), centre


def gravity_rotation(down: np.ndarray) -> np.ndarray:
    """The least rotation that takes the unit vector ``down`` to (0, 0, −1)."""
    target = np.array([0.0, 0.0, -1.0])
    axis = np.cross(down, target)
    s, c = np.linalg.norm(axis), float(down @ target)
    if s < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    return exp_so3(axis / s * np.arctan2(s, c))


def matrix44(values) -> np.ndarray:
    return np.asarray(values, np.float64).reshape(4, 4)


class Motion:
    """The body's continuous trajectory in the gravity-down world."""

    def __init__(self, config: dict, seed: int):
        p = config["map"]
        self.p = p
        # the phases are the first draw of mapgen.generate's generator
        self.ph = mapgen.rng_for(seed).uniform(0, 2 * np.pi, 4)
        self.rate = p["speed_mps"] / p["radius_m"]                 # loop angle a second
        R0, c0 = hall_pose(np.array([self.ph[0]]), p, self.ph)
        self.R0, self.c0 = R0[0], c0[0]
        # mapgen's world is the first camera's; its y axis in the hall is down
        self.Rg = gravity_rotation(self.R0.T @ np.array([0.0, 1.0, 0.0]))
        T_bc = matrix44(config["imu"]["T_b_c1"])
        self.R_cb, self.t_cb = T_bc[:3, :3].T, -T_bc[:3, :3].T @ T_bc[:3, 3]
        self.g = np.array([0.0, 0.0, -p["gravity_mps2"]])

    def camera(self, t: np.ndarray):
        """Camera → world (gravity-down) rotations and centres at times t."""
        R, c = hall_pose(self.ph[0] + self.rate * np.asarray(t, np.float64), self.p, self.ph)
        Rw = self.Rg @ self.R0.T
        return Rw @ R, np.einsum("ij,...j->...i", Rw, c - self.c0)

    def body(self, t: np.ndarray):
        """Body → world rotations and positions at times t."""
        R_wc, c = self.camera(t)
        return R_wc @ self.R_cb, c + np.einsum("...ij,j->...i", R_wc, self.t_cb)

    def imu(self, t: np.ndarray, h: float = 1e-3):
        """(angular rate, specific force) in the body at times t, and the
        world velocity, by central differences."""
        Rm, pm = self.body(t - h)
        R0, p0 = self.body(t)
        Rp, pp = self.body(t + h)
        gyro = log_so3(np.swapaxes(Rm, -1, -2) @ Rp) / (2 * h)
        acc_w = (pp - 2 * p0 + pm) / (h * h)
        force = np.einsum("...ji,...j->...i", R0, acc_w - self.g)
        return gyro, force, (pp - pm) / (2 * h)


def preintegrate(acc: np.ndarray, gyro: np.ndarray, dt: float, bg: np.ndarray, ba: np.ndarray,
                 sigma_gyro: float, sigma_acc: float) -> dict:
    """The preintegration of each pair's samples (acc, gyro (P, S, 3), each
    sample ``dt`` long) at its bias (bg, ba (P, 3)), float64; ``sigma_gyro``
    and ``sigma_acc`` a sample's noise deviation (``IMU::Calib``'s)."""
    P, S = acc.shape[:2]
    eye = np.broadcast_to(np.eye(3), (P, 3, 3))
    dR, dV, dP = eye.copy(), np.zeros((P, 3)), np.zeros((P, 3))
    JRg, JVg, JVa, JPg, JPa = (np.zeros((P, 3, 3)) for _ in range(5))
    cov = np.zeros((P, 9, 9))
    nga = np.array([sigma_gyro ** 2] * 3 + [sigma_acc ** 2] * 3)
    for s in range(S):
        a = acc[:, s] - ba
        wdt = (gyro[:, s] - bg) * dt
        dRi, Jr, ah = exp_so3(wdt), right_jacobian(wdt), hat(a)
        Ra = np.einsum("pij,pj->pi", dR, a)
        dP = dP + dV * dt + 0.5 * Ra * dt * dt
        dV = dV + Ra * dt
        Rah = dR @ ah
        A = np.zeros((P, 9, 9))
        A[:, 0:3, 0:3] = np.swapaxes(dRi, -1, -2)
        A[:, 3:6, 0:3] = -Rah * dt
        A[:, 6:9, 0:3] = -0.5 * Rah * dt * dt
        A[:, 3:6, 3:6] = np.eye(3)
        A[:, 6:9, 3:6] = np.eye(3) * dt
        A[:, 6:9, 6:9] = np.eye(3)
        B = np.zeros((P, 9, 6))
        B[:, 0:3, 0:3] = Jr * dt
        B[:, 3:6, 3:6] = dR * dt
        B[:, 6:9, 3:6] = 0.5 * dR * dt * dt
        cov = A @ cov @ np.swapaxes(A, -1, -2) + (B * nga) @ np.swapaxes(B, -1, -2)
        RahJ = Rah @ JRg
        JPa = JPa + JVa * dt - 0.5 * dR * dt * dt
        JPg = JPg + JVg * dt - 0.5 * RahJ * dt * dt
        JVa = JVa - dR * dt
        JVg = JVg - RahJ * dt
        JRg = np.swapaxes(dRi, -1, -2) @ JRg - Jr * dt
        dR = dR @ dRi
    return dict(dt=np.full(P, S * dt), dR=mapgen.matrix_to_quat(dR), dV=dV, dP=dP, JRg=JRg,
                JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, cov=cov, bg=bg, ba=ba)


def flatten(pre: dict) -> np.ndarray:
    """(P, 143) float32 rows in ``PREINT_LAYOUT`` order."""
    P = len(pre["dt"])
    return np.concatenate([np.asarray(pre[k], np.float64).reshape(P, -1)
                           for k, _ in PREINT_LAYOUT], axis=1).astype(np.float32)


def unflatten(rows: np.ndarray) -> dict:
    """``flatten``'s inverse, as float64 arrays."""
    out, i = {}, 0
    for k, shape in PREINT_LAYOUT:
        n = int(np.prod(shape))
        out[k] = np.asarray(rows[:, i:i + n], np.float64).reshape((len(rows),) + shape)
        i += n
    return out


def _rotate_poses(pose7: np.ndarray, Rg: np.ndarray) -> np.ndarray:
    """Tcw poses of the first-camera world → the gravity-down world."""
    R = mapgen.quat_to_matrix(pose7[:, :4]) @ Rg.T
    return np.concatenate([mapgen.matrix_to_quat(R), np.asarray(pose7[:, 4:7], np.float64)], -1)


def generate(config: dict, cell: dict, seed: int) -> dict:
    """``mapgen.generate``'s map in the gravity-down world, with the IMU:
    ``kf_time`` (K,), the map's ``kf_vel``, ``kf_bg``, ``kf_ba`` (K, 3)
    float32 after the correction, the truth ``true_vel``, ``true_bg``,
    ``true_ba``, and ``preint`` (K − 1, 143) float32, pair k the
    preintegration from keyframe k to k + 1."""
    p, imu = config["map"], config["imu"]
    if abs(p["kf_spacing_m"] - p["speed_mps"] * p["kf_dt_s"]) > 1e-9:
        raise ValueError("kf_spacing_m must be speed_mps × kf_dt_s")
    if p["trajectory"] != "hall_loops":
        raise ValueError("the inertial map follows the hall_loops trajectory")
    maparr = mapgen.generate(config, cell, seed)
    motion = Motion(config, seed)
    K = len(maparr["kf_pose"])
    rng = np.random.default_rng([int(seed) % 2 ** 64, 1])
    Rg = motion.Rg

    # the map in the gravity-down world
    kf_pose = _rotate_poses(maparr["kf_pose"], Rg).astype(np.float32)
    true_pose = _rotate_poses(maparr["true_pose"], Rg)
    lm_pos = (np.asarray(maparr["lm_pos"], np.float64) @ Rg.T).astype(np.float32)
    true_lm = maparr["true_lm"] @ Rg.T

    # the IMU's samples: rates, forces, biases walking from a seeded draw
    rate = float(imu["frequency_hz"])
    n_per = int(round(p["kf_dt_s"] * rate))
    dt = 1.0 / rate
    t_s = np.arange((K - 1) * n_per + 1) * dt
    gyro, force, _ = motion.imu(t_s)
    b = p["true_bias"]
    n = len(t_s)
    bg = (rng.normal(size=3) * b["bg_radps"] / np.sqrt(3)
          + np.cumsum(rng.normal(size=(n, 3)) * imu["gyro_walk"] * np.sqrt(dt), axis=0))
    ba = (rng.normal(size=3) * b["ba_mps2"] / np.sqrt(3)
          + np.cumsum(rng.normal(size=(n, 3)) * imu["acc_walk"] * np.sqrt(dt), axis=0))
    # a sample's deviation: the density × √rate, as IMU::Calib holds it
    sigma_gyro, sigma_acc = imu["noise_gyro"] * np.sqrt(rate), imu["noise_acc"] * np.sqrt(rate)
    gyro_m = gyro + bg + rng.normal(size=(n, 3)) * sigma_gyro
    acc_m = force + ba + rng.normal(size=(n, 3)) * sigma_acc

    # the truth at the keyframes, and the map's estimate after the correction
    t_kf = np.arange(K) * p["kf_dt_s"]
    _, _, true_vel = motion.imu(t_kf)
    kf_s = np.arange(K) * n_per
    e = p["post_correction"]
    vel = true_vel + rng.normal(size=(K, 3)) * e["vel_mps"] / np.sqrt(3)
    est_bg = bg[kf_s] + rng.normal(size=3) * e["bg_radps"] / np.sqrt(3)
    est_ba = ba[kf_s] + rng.normal(size=3) * e["ba_mps2"] / np.sqrt(3)
    vel[0], est_bg[0], est_ba[0] = true_vel[0], bg[0], ba[0]      # keyframe 0 is fixed
    kf_vel, kf_bg, kf_ba = (a.astype(np.float32) for a in (vel, est_bg, est_ba))

    # each pair k → k + 1 over its samples, at keyframe k's bias as the map holds it
    idx = kf_s[:-1, None] + np.arange(n_per)[None]
    pre = preintegrate(acc_m[idx], gyro_m[idx], dt, kf_bg[:-1].astype(np.float64),
                       kf_ba[:-1].astype(np.float64), sigma_gyro, sigma_acc)
    maparr.update(kf_pose=kf_pose, true_pose=true_pose, lm_pos=lm_pos, true_lm=true_lm,
                  kf_time=t_kf, kf_vel=kf_vel, kf_bg=kf_bg, kf_ba=kf_ba, true_vel=true_vel,
                  true_bg=bg[kf_s], true_ba=ba[kf_s], preint=flatten(pre))
    return maparr
