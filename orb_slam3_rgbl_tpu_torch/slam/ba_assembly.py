"""MapState → BAProblem assembly (counterpart of
``orb_slam3_rgbl_tpu.slam.ba_assembly``; shared by local BA, and by global
BA and map merging once they are ported).

The problem pads to capacity tiers (powers of two) so that the solver sees
few distinct shapes over a run. Under ``torch.profiler`` the whole-map
assembly is the span ``gba.build``, and its gather of the observation table
(with the octave lookup) the span ``gba.gather`` inside it
(``utils/profiling.tracer``).

``build_full_vi_problem`` assembles the whole map of an initialized
inertial map for ``optim/global_inertial_ba``: every keyframe's body state,
every landmark and the observation table in the visual problem's layout
(no padding tiers), and one pair a link of the temporal IMU chain
(``kf_prev_imu``) with its preintegration.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.optim.inertial_ba import VIBAProblem
from orb_slam3_rgbl_tpu_torch.optim.local_ba import BAProblem
from orb_slam3_rgbl_tpu_torch.slam import imu_frontend
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState
from orb_slam3_rgbl_tpu_torch.utils.profiling import tracer


def _tier(n: int, lo: int) -> int:
    t = lo
    while t < n:
        t *= 2
    return t


def _gather(m: MapState, inv_sigma2: np.ndarray, max_obs: int, span):
    """What both whole-map builders start from: the valid keyframes
    (``window``), the valid landmarks, their observation table (obs_kf,
    obs_feat, obs_mask, obs_uv, obs_ur) and each observation's octave weight,
    gathered inside ``gba.gather``, and the gauge over the window: the
    origin keyframe fixed, else the oldest."""
    window = m.valid_kf_ids()
    lm_ids = np.nonzero(m.lm_valid)[0]
    with span("gba.gather"):
        obs = m.gather_observations(window, lm_ids, max_obs)
        kf_global = window[np.clip(obs[0], 0, max(len(window) - 1, 0))]
        octv = m.kf_octave[kf_global, obs[1]].astype(np.int32)
        inv_s2 = inv_sigma2[np.clip(octv, 0, len(inv_sigma2) - 1)].astype(np.float32)
    fixed = np.zeros(len(window), bool)
    fixed[np.nonzero(window == 0)[0]] = True
    if len(window) and not fixed.any():
        fixed[int(np.argmin(m.kf_frame_id[window]))] = True
    return window, lm_ids, obs, inv_s2, fixed


def build_full_problem(
    m: MapState,
    inv_sigma2: np.ndarray,
    max_obs: int = 8,
    min_pose_tier: int = 32,
    min_lm_tier: int = 1024,
    device=None,
) -> Tuple[BAProblem, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Whole-map BA problem (origin keyframe gauge-fixed) on ``device``
    (default ``cuda``).

    Returns (problem, window_kf_ids, lm_ids, obs_kf_raw, obs_feat): the raw
    index arrays let callers write results and outlier unbinding back into
    the map."""
    dev = resolve(device)
    span = tracer(dev)
    with span("gba.build"):
        window, lm_ids, obs, inv_s2, fixed = _gather(m, inv_sigma2, max_obs, span)
        obs_kf, obs_feat, obs_mask, obs_uv, obs_ur = obs
        Kp = _tier(len(window), min_pose_tier)
        Mp = _tier(max(len(lm_ids), 1), min_lm_tier)

        def pad(a, n, fill=0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: a.shape[0]] = a
            return out

        poses = pad(m.kf_pose[window], Kp)
        poses[len(window):, 0] = 1.0  # identity quaternions for padding
        pose_fixed = pad(fixed, Kp, False)
        pose_valid = pad(np.ones(len(window), bool), Kp, False)

        def up(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        f32 = torch.float32
        problem = BAProblem(
            poses=up(poses, f32),
            pose_fixed=up(pose_fixed, torch.bool),
            pose_valid=up(pose_valid, torch.bool),
            landmarks=up(pad(m.lm_pos[lm_ids], Mp), f32),
            lm_valid=up(pad(np.ones(len(lm_ids), bool), Mp, False), torch.bool),
            obs_kf=up(pad(obs_kf, Mp), torch.int64),
            obs_uv=up(pad(obs_uv, Mp), f32),
            obs_ur=up(pad(obs_ur, Mp, -1.0), f32),
            obs_inv_sigma2=up(pad(inv_s2, Mp), f32),
            obs_mask=up(pad(obs_mask, Mp, False), torch.bool),
        )
    return problem, window, lm_ids, obs_kf, obs_feat


def build_full_vi_problem(m: MapState, inv_sigma2: np.ndarray, imu_cfg, max_obs: int = 8,
                          device=None):
    """Whole-map visual-inertial BA problem on ``device`` (default ``cuda``):
    the body state [Twb, velocity, gyro bias, accel bias] of every valid
    keyframe (the origin keyframe's state fixed whole), every valid landmark,
    the observation table as ``build_full_problem`` gathers it, and one pair
    (``kf_prev_imu[k]``, k) for each keyframe k whose predecessor on the
    temporal chain is a valid keyframe, valid where the map holds k's
    preintegration. ``imu_cfg``: the ``ImuConfig`` (the extrinsic and the
    bias walks; the walks' information as ``LocalMapper._build_vi_problem``
    computes it). No padding tiers: the real numbers of states, landmarks
    and pairs.

    Returns (problem, window_kf_ids, lm_ids, obs_kf_raw, obs_feat)."""
    dev = resolve(device)
    span = tracer(dev)
    with span("gba.build"):
        window, lm_ids, obs, inv_s2, fixed = _gather(m, inv_sigma2, max_obs, span)
        obs_kf, obs_feat, obs_mask, obs_uv, obs_ur = obs
        K = len(window)
        T_bc, T_cb = imu_frontend.extrinsics(imu_cfg)
        Twb = lie.np_se3_inv(lie.np_se3_mul(np.tile(T_bc, (K, 1)), m.kf_pose[window]))

        # the temporal chain's links inside the window, in keyframe order
        slot = np.full(m.capacity_kf, -1, np.int64)
        slot[window] = np.arange(K)
        prev = m.kf_prev_imu[window].astype(np.int64)
        linked = np.nonzero((prev >= 0) & (slot[np.maximum(prev, 0)] >= 0))[0]
        pair_i, pair_j = slot[prev[linked]], linked
        valid = np.array([int(window[j]) in m.imu_preint for j in linked], bool)
        preints = [m.imu_preint[int(window[j])] if ok else imu_frontend.zero_preint_numpy()
                   for j, ok in zip(linked, valid)]
        dts = np.maximum(np.array([float(t[0]) for t in preints], np.float64), 1e-3)
        info_bg = np.minimum(1.0 / np.maximum(imu_cfg.gyro_walk ** 2 * dts, 1e-12), 1e8)
        info_ba = np.minimum(1.0 / np.maximum(imu_cfg.acc_walk ** 2 * dts, 1e-12), 1e8)

        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

        f32 = torch.float32
        problem = VIBAProblem(
            Twb=up(Twb, f32), vel=up(m.kf_vel[window], f32), bg=up(m.kf_bg[window], f32),
            ba=up(m.kf_ba[window], f32), state_fixed=up(fixed, torch.bool),
            state_valid=up(np.ones(K, bool), torch.bool), T_cb=up(T_cb, f32),
            landmarks=up(m.lm_pos[lm_ids], f32), lm_valid=up(np.ones(len(lm_ids), bool),
                                                             torch.bool),
            obs_kf=up(obs_kf, torch.int64), obs_uv=up(obs_uv, f32), obs_ur=up(obs_ur, f32),
            obs_inv_sigma2=up(inv_s2, f32), obs_mask=up(obs_mask, torch.bool),
            pair_i=up(pair_i, torch.int64), pair_j=up(pair_j, torch.int64),
            pair_meas=imu_frontend.stack_preints(preints, dev),
            pair_valid=up(valid, torch.bool), info_bg=up(info_bg, f32),
            info_ba=up(info_ba, f32))
    return problem, window, lm_ids, obs_kf, obs_feat


def writeback(
    m: MapState,
    window: np.ndarray,
    lm_ids: np.ndarray,
    obs_kf: np.ndarray,
    obs_feat: np.ndarray,
    poses,
    landmarks,
    obs_inlier=None,
    obs_mask=None,
):
    """Apply solver output (numpy arrays) to the map: a plain array store
    that bumps the version; observations classified outlier are unbound."""
    m.kf_pose[window] = np.asarray(poses, np.float32)[: len(window)]
    m.lm_pos[lm_ids] = np.asarray(landmarks, np.float32)[: len(lm_ids)]
    if obs_inlier is not None and obs_mask is not None:
        inl = np.asarray(obs_inlier)[: len(lm_ids)]
        bad = (~inl) & obs_mask
        if bad.any():
            mr, dc = np.nonzero(bad)
            kfg = window[obs_kf[mr, dc]]
            m.kf_lm_idx[kfg, obs_feat[mr, dc]] = -1
            m.cull_orphans(lm_ids[np.unique(mr)])
    m.version += 1
