"""MapState → BAProblem assembly (counterpart of
``orb_slam3_rgbl_tpu.slam.ba_assembly``; shared by local BA, and by global
BA and map merging once they are ported).

The problem pads to capacity tiers (powers of two) so that the solver sees
few distinct shapes over a run.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.optim.local_ba import BAProblem
from orb_slam3_rgbl_tpu_torch.slam.map_state import MapState


def _tier(n: int, lo: int) -> int:
    t = lo
    while t < n:
        t *= 2
    return t


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
    window = m.valid_kf_ids()
    lm_ids = np.nonzero(m.lm_valid)[0]
    Kp = _tier(len(window), min_pose_tier)
    Mp = _tier(max(len(lm_ids), 1), min_lm_tier)

    obs_kf, obs_feat, obs_mask, obs_uv, obs_ur = m.gather_observations(window, lm_ids, max_obs)

    def pad(a, n, fill=0):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    poses = pad(m.kf_pose[window], Kp)
    poses[len(window):, 0] = 1.0  # identity quaternions for padding
    pose_fixed = np.zeros(Kp, bool)
    pose_fixed[np.nonzero(window == 0)[0]] = True
    if not pose_fixed[: len(window)].any():
        pose_fixed[int(np.argmin(m.kf_frame_id[window]))] = True
    pose_valid = pad(np.ones(len(window), bool), Kp, False)

    kf_global = window[np.clip(obs_kf, 0, len(window) - 1)]
    octv = m.kf_octave[kf_global, obs_feat].astype(np.int32)
    inv_s2 = inv_sigma2[np.clip(octv, 0, len(inv_sigma2) - 1)].astype(np.float32)

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
